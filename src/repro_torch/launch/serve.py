"""Serving launcher of the port: continuous-batching engine over a
checkpoint or a weights store.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
        --reduced --requests 8 --slots 4 [--ckpt-dir /tmp/repro_ckpts] \\
        [--device cpu]

The counterpart of ``repro.launch.serve``, option for option, on the
port's ``ServeEngine``, ``ModelRepo`` and ``DeltaCheckpointer``. Loads
params onto ``--device`` (``cuda`` by default) from the latest delta-lake
checkpoint when one exists (any writer's: the reference's checkpoints
restore here too), else serves weights drawn from ``--seed``. With
``--weights-dir`` the params come from a serve-weights store instead,
through the snapshot-pinned ``store.models(prefix)`` handle (one merged
cold-start fetch plan, seeded with fresh weights when the prefix is
empty); the engine owns that handle and releases its lease on close.

Prompts are drawn from ``np.random.default_rng(--seed)`` as the reference
draws them, so both launchers serve the same requests; the vlm gets zero
``image_embeds``, as there. :func:`main` returns the finished requests.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from ..lake import LocalFSObjectStore
from ..lake.device import resolve_device
from ..models import get_arch, transformer
from ..models.layers import dtype_of
from ..serve import Request, ServeEngine
from ..train import checkpoint as ckpt_mod, trainer


def parse_args(argv=None):
    """The launcher's command line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-shards", type=int, default=None,
                    help="shard count for the checkpoint store (fixed at "
                         "store-create time; omit to use what exists)")
    ap.add_argument("--ckpt-gc-keep", type=int, default=None,
                    help="after the restore completes, prune checkpoints "
                         "beyond the newest N and vacuum the reclaimed "
                         "bytes")
    ap.add_argument("--weights-dir", default=None,
                    help="serve-weights store directory; loads params via "
                         "store.models(--weights-prefix) instead of a "
                         "checkpoint")
    ap.add_argument("--weights-prefix", default="serve_weights",
                    help="model prefix inside --weights-dir")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Request]:
    """Serve ``--requests`` seeded prompts; returns the finished requests."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name}: no decode step")

    def fresh():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return transformer.init_params(cfg, gen, device=dev)

    params = None
    repo = None
    if args.weights_dir:
        from ..core import DeltaTensorStore
        wstore = DeltaTensorStore(LocalFSObjectStore(args.weights_dir),
                                  "weights", device=dev)
        repo = wstore.models(args.weights_prefix)
        if repo.exists():
            params = repo.load(transformer.init_params(cfg, device="meta"))
            print(f"[serve] loaded {repo.stats()['leaves']} param leaves "
                  f"from {args.weights_dir!r} prefix "
                  f"{args.weights_prefix!r} @ v{repo.version}")
        else:
            params = fresh()
            repo.save(params)
            print(f"[serve] seeded fresh weights into {args.weights_dir!r} "
                  f"prefix {args.weights_prefix!r}")
    elif args.ckpt_dir:
        ckpt = ckpt_mod.DeltaCheckpointer(LocalFSObjectStore(args.ckpt_dir),
                                          shards=args.ckpt_shards, device=dev)
        if ckpt.restore_available():
            step, state = ckpt.restore(trainer.init_state(cfg, device="meta"))
            params = state.params
            del state
            print(f"[serve] restored params from checkpoint step {step}")
            if args.ckpt_gc_keep is not None:
                gc = ckpt.gc(keep=args.ckpt_gc_keep)
                print(f"[serve] checkpoint gc: pruned steps "
                      f"{gc['pruned_steps']}, reclaimed "
                      f"{gc['bytes_reclaimed']} bytes "
                      f"({gc['files_deleted']} files)")
    if params is None:
        params = fresh()

    extra = {}
    if cfg.family == "vlm":
        extra["image_embeds"] = torch.zeros(
            (args.slots, cfg.n_image_tokens, cfg.d_model),
            dtype=dtype_of(cfg.dtype), device=dev)
    with ServeEngine(params, cfg, n_slots=args.slots, max_len=args.max_len,
                     extra_inputs=extra, repo=repo) as eng:
        rng = np.random.default_rng(args.seed)
        reqs = [Request(rid=i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            (int(rng.integers(4, 24)),)).astype(np.int32),
                        max_new_tokens=args.max_new)
                for i in range(args.requests)]
        for r in reqs:
            eng.submit(r)
        t0 = time.time()
        eng.run_until_drained()
        dt = time.time() - t0
        tok = sum(len(r.out_tokens) for r in reqs)
        print(f"[serve] {len(reqs)} requests, {tok} tokens, {dt:.2f}s "
              f"({tok/dt:.1f} tok/s) on {args.slots} slots ({dev})")
    return reqs


if __name__ == "__main__":
    main()
