"""Serving example: continuous batching over a reduced model on the card.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch glm4-9b \\
        --requests 12 [--from-store] [--layers L] [--device cpu]

Requests with ragged prompt lengths stream through a fixed pool of slots;
a finished sequence's slot is at once re-admitted from the queue. The
config is the arch's ``reduced()`` twin (``--layers`` sets its depth), and
the weights are drawn from a seeded ``torch.Generator`` on ``--device``
(``cuda`` by default).

With ``--from-store`` the weights round-trip through the Delta Tensor
store first via ``store.models(prefix)``: saved as one FTSF tensor per
param leaf, then cold-start loaded onto the device through one merged
fetch plan (``block_gather`` reorders the chunk rows on the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..lake.device import resolve_device
from ..models import get_arch, transformer
from ..serve import Request, ServeEngine


def parse_args(argv=None):
    """The example's command line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth of the reduced config (default: its own)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--from-store", action="store_true",
                    help="round-trip weights through the Delta Tensor store")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    """Serve ``--requests`` random prompts and print the throughput."""
    args = parse_args(argv)
    cfg = get_arch(args.arch).reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(cfg, gen, device=dev)

    if args.from_store:
        from ..core import DeltaTensorStore
        from ..lake import InMemoryObjectStore, ReadExecutor
        store = DeltaTensorStore(InMemoryObjectStore(), "weights",
                                 io=ReadExecutor(max_workers=8), device=dev)
        with store.models(cfg.name) as repo:
            repo.save(params)
            t0 = time.time()
            params = repo.load(transformer.init_params(cfg, device="meta"))
        st = store.io.stats
        print(f"weights loaded from delta store in {time.time() - t0:.2f}s "
              f"(gets={st.gets} cache_hits={st.cache_hits})")

    eng = ServeEngine(params, cfg, n_slots=args.slots, max_len=128)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        (int(rng.integers(4, 24)),)
                                        ).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)

    t0 = time.time()
    iters = 0
    while any(not r.done for r in reqs):
        eng.step()
        iters += 1
        if iters > 10_000:
            raise RuntimeError("stuck")
    dt = time.time() - t0
    total_tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"arch={cfg.name} layers={cfg.n_layers} slots={args.slots} "
          f"device={dev}")
    print(f"served {len(reqs)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s, {iters} engine steps)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens[:8]}...")


if __name__ == "__main__":
    main()
