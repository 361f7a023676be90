"""Cross-pod gradient compression demo of the port — the paper's BSGS on
the wire.

    PYTHONPATH=src python -m repro_torch.examples.grad_compression \\
        --steps 40 [--device cpu]

Two simulated pods train in data parallel on ``--device`` (``cuda`` by
default); each step exchanges only the top-k energy blocks of the
gradients (+ error feedback), through ``block_norms``, ``block_gather``
and ``block_scatter`` on the card. The demo compares loss curves and wire
bytes against dense synchronization (ratio 1.0), as
``examples/grad_compression.py`` does.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..lake.device import resolve_device
from ..models import get_arch
from ..train import optimizer as opt, trainer


def run(compressed: bool, steps: int, ratio: float, *, device="cuda",
        state: Optional[trainer.CompressedTrainState] = None
        ) -> Tuple[List[float], float]:
    """(losses, last wire ratio) of ``steps`` compressed steps over 2 pods
    of reduced granite-3-8b; ``state`` (2 pods, on ``device``) replaces the
    seeded initial state, e.g. the reference's carried over with
    ``trainer.state_from_numpy``."""
    dev = resolve_device(device)
    cfg = get_arch("granite-3-8b").reduced()
    ocfg = opt.OptConfig(lr=5e-3, warmup_steps=5, total_steps=steps)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 32)),
                             dtype=torch.int32)
    labels = torch.cat([tokens[:, 1:], -torch.ones((4, 1), dtype=torch.int32)],
                       1)
    batch = {"tokens": tokens.reshape(2, 2, 32).to(dev),
             "labels": labels.reshape(2, 2, 32).to(dev)}

    if state is None:
        state = trainer.init_compressed_state(
            cfg, torch.Generator(device=dev).manual_seed(0), n_pods=2,
            device=dev)
    step = trainer.make_compressed_train_step(
        cfg, ocfg, ratio=ratio if compressed else 1.0)

    losses, wire = [], 1.0
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        wire = float(m["wire_ratio"])
    return losses, wire


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--ratio", type=float, default=0.25)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    dense_losses, dense_wire = run(False, args.steps, 1.0, device=args.device)
    comp_losses, comp_wire = run(True, args.steps, args.ratio,
                                 device=args.device)
    print(f"{'step':>5} {'dense':>8} {'compressed':>11}")
    for i in range(0, args.steps, max(args.steps // 10, 1)):
        print(f"{i:>5} {dense_losses[i]:>8.3f} {comp_losses[i]:>11.3f}")
    print(f"\nfinal: dense {dense_losses[-1]:.3f} (wire ratio {dense_wire:.2f}) "
          f"vs compressed {comp_losses[-1]:.3f} (wire ratio {comp_wire:.3f})")
    print(f"cross-pod traffic cut to {comp_wire:.1%} with final-loss delta "
          f"{comp_losses[-1]-dense_losses[-1]:+.4f} (error feedback re-injects "
          f"dropped blocks; see tests/test_torch_train.py for the step-by-step "
          f"check against the reference)")


if __name__ == "__main__":
    main()
