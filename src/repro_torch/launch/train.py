"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --reduced --steps 100 --ckpt-dir build/ckpts [--device cpu]

Tokens come from an FTSF corpus in a delta table under ``--data-dir``
(written on first use), batches through ``FTSFLoader``, and the state is
checkpointed into a ``DeltaCheckpointer`` under ``--ckpt-dir`` every
``--ckpt-every`` steps, uploading while the next steps run. A restart
resumes from the last committed step, restored straight onto
``--device`` (``cuda`` by default). ``--reduced`` uses the arch's smoke-twin
config.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..core.store import DeltaTensorStore
from ..data.pipeline import FTSFLoader, write_token_dataset
from ..data.synthetic import token_stream
from ..lake import LocalFSObjectStore
from ..lake.device import resolve_device
from ..models import get_arch, transformer
from ..train import checkpoint as ckpt_mod, optimizer as opt, trainer


def parse_args(argv=None):
    """The launcher's command line."""
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-twin config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tmp, "repro_torch_ckpts"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-dir", default=os.path.join(tmp, "repro_torch_data"))
    ap.add_argument("--host-index", type=int, default=0)
    ap.add_argument("--n-hosts", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap.parse_args(argv)


def to_batch(b, dev):
    """A loader batch as ``tokens`` / ``labels`` tensors on ``dev``."""
    return {k: torch.as_tensor(b[k]).to(dev) for k in ("tokens", "labels")}


def main(argv=None) -> None:
    """Train ``--steps`` steps, resuming from the last checkpoint."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} device={dev}")

    data_store = DeltaTensorStore(LocalFSObjectStore(args.data_dir),
                                  "datasets", device=dev)
    try:
        data_store.shape_of("corpus")
    except KeyError:
        tokens = token_stream(max(1024, 8 * args.batch), args.seq,
                              cfg.vocab_size, seed=args.seed)
        write_token_dataset(data_store, tokens, tensor_id="corpus")

    ocfg = opt.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                         total_steps=args.steps)
    ckpt = ckpt_mod.DeltaCheckpointer(LocalFSObjectStore(args.ckpt_dir),
                                      device=dev)
    start = 0
    if ckpt.restore_available():
        start, state = ckpt.restore(trainer.init_state(cfg, device="meta"))
        print(f"[train] resumed from committed step {start}")
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        state = trainer.init_state(cfg, gen, device=dev)
    step_fn = trainer.make_train_step(cfg, ocfg)
    print(f"[train] params {transformer.param_count(state.params)}")

    # the batch order is a function of the seed: a resumed run replays
    # exactly the batches the lost steps would have seen
    loader = FTSFLoader(data_store, "corpus", batch_size=args.batch,
                        host_index=args.host_index, n_hosts=args.n_hosts,
                        seed=args.seed, start_step=start)
    it = iter(loader)
    t0 = time.time()
    for i in range(start, args.steps):
        state, m = step_fn(state, to_batch(next(it), dev))
        if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
            ckpt.save_async(i + 1, state)
        if (i + 1) % 10 == 0:
            print(f"[train] step {i+1:5d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} "
                  f"({(i+1-start)/(time.time()-t0):.2f} steps/s)")
    ckpt.wait()
    loader.close()
    print(f"[train] done; checkpoints at steps {ckpt.steps()}")


if __name__ == "__main__":
    main()
