"""End-to-end training example of the port: FTSF data pipeline -> train ->
delta checkpoints -> crash -> restore -> resume.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch glm4-9b
    PYTHONPATH=src python -m repro_torch.examples.train_lm --size 100m --steps 300

The dataset lives as FTSF chunk rows in a delta table (a batch fetch is
the paper's slice read), checkpoints are incremental FTSF tensors committed
atomically while the next steps run, and the run shows a failure
mid-training and a restore from the last commit onto ``--device`` (``cuda``
by default). ``--ckpt-every`` must divide ``steps // 2``: the restore needs
a checkpoint before the simulated failure.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..core import DeltaTensorStore
from ..data.pipeline import FTSFLoader, write_token_dataset
from ..data.synthetic import token_stream
from ..lake import InMemoryObjectStore
from ..lake.device import resolve_device
from ..models import get_arch, transformer
from ..models.config import ArchConfig, register_arch
from ..train import checkpoint as ckpt_mod, optimizer as opt, trainer


def size_100m() -> ArchConfig:
    """A ~100M-parameter dense config."""
    return register_arch(ArchConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=8192, head_dim=64,
        dtype="float32", attn_chunk_q=128, attn_chunk_kv=128))


def parse_args(argv=None):
    """The example's command line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--size", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    """Train, fail at half the steps, restore and finish."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = size_100m() if args.size == "100m" else get_arch(args.arch).reduced()
    if args.size == "100m":
        args.seq = max(args.seq, 128)
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"device={dev}")

    # --- dataset as FTSF rows in the delta lake -----------------------------
    obj = InMemoryObjectStore()
    data_store = DeltaTensorStore(obj, "datasets", device=dev)
    tokens = token_stream(1024, args.seq, cfg.vocab_size)
    write_token_dataset(data_store, tokens, tensor_id="corpus")
    loader = FTSFLoader(data_store, "corpus", batch_size=args.batch, seed=0)

    def batch(b):
        return {k: torch.as_tensor(b[k]).to(dev) for k in ("tokens", "labels")}

    # --- train state and step -----------------------------------------------
    ocfg = opt.OptConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = trainer.init_state(cfg, gen, device=dev)
    print(f"params: {transformer.param_count(state.params) / 1e6:.1f}M")
    step_fn = trainer.make_train_step(cfg, ocfg)
    ckpt = ckpt_mod.DeltaCheckpointer(obj, "checkpoints", device=dev)

    it = iter(loader)
    t0 = time.time()
    crash_at = args.steps // 2
    losses = []
    for i in range(crash_at):
        state, m = step_fn(state, batch(next(it)))
        losses.append(float(m["loss"]))
        if (i + 1) % args.ckpt_every == 0:
            ckpt.save_async(i + 1, state)     # overlaps the next steps
        if (i + 1) % 20 == 0:
            print(f"step {i+1:4d} loss {losses[-1]:.3f} "
                  f"({(i+1)/(time.time()-t0):.1f} steps/s)")
    ckpt.wait()

    # --- simulated failure + restore ----------------------------------------
    print(f"\n-- simulating node failure at step {crash_at} --")
    del state
    step_found, state = ckpt.restore(trainer.init_state(cfg, device="meta"))
    print(f"restored checkpoint of step {step_found} "
          f"(lost {crash_at - step_found} steps, by design)")

    loader2 = FTSFLoader(data_store, "corpus", batch_size=args.batch, seed=0,
                         start_step=step_found)
    it = iter(loader2)
    for i in range(step_found, args.steps):
        state, m = step_fn(state, batch(next(it)))
        losses.append(float(m["loss"]))
        if (i + 1) % 20 == 0:
            print(f"step {i+1:4d} loss {float(m['loss']):.3f}")
        if (i + 1) % args.ckpt_every == 0:
            ckpt.save_async(i + 1, state)
    ckpt.wait()
    loader.close()
    loader2.close()
    print(f"\nfinal loss {losses[-1]:.3f} (start {losses[0]:.3f}); "
          f"checkpoints at steps {ckpt.steps()}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("training should reduce loss")


if __name__ == "__main__":
    main()
