#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py [--images N] [--layers L]

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/
   csrc`` (one nvcc per source, all at once) and print the build seconds and
   ptxas's register / shared-memory / spill report;
2. check each kernel against its plain PyTorch version on the card, over
   dtype and shape sweeps (ragged shapes, misaligned bases and ids out of
   range included) that reach every variant of ``unshuffle`` and
   ``block_gather``, and at the main path's shapes, printing the variant
   each main-shape call took: the max difference must be 0, except for the
   scatter-add of duplicate float indices (atomics add in another order),
   held to ``rtol = atol = 1e-6``, and ``block_norms`` of non-dyadic data
   (positive f32 terms summed in another order), held to ``rtol = 1e-5,
   atol = 0``; ``block_norms`` of dyadic data (small integers / 8) must be
   exact;
3. time each kernel at the main path's shapes with CUDA events (the median
   of 5 samples, each the mean of back-to-back calls, with their min and
   max; ``unshuffle`` and ``block_gather`` in samples alternating with
   their library call), beside its bound (bytes moved / 3.35 TB/s), its
   plain version and one PyTorch call computing the same function
   (``library_ms``; the port never calls it); the device time per launch
   of ``unshuffle`` and ``block_gather`` and of their library calls from
   torch.profiler; ``block_gather``'s two variants in turns at the main
   shape, and at the compressor's (8, 128) shape; the frame-decode hook's
   wall and device time per 12 MiB chunk in turns with the other ways to
   the same bytes, and its split (H2D, kernel, D2H, and the pinned
   alternatives); the host time of the launch path's parts;
4. drive the store's device read path at the paper's width: N FFHQ-like
   images of 3x1024x1024 f32 (N = 256 by default; ``--images`` cuts the
   image count, never the image shape) stored as FTSF with 3-D chunks under
   ``zlib+shuffle``, and the Uber-pickups tensor (183, 24, 285, 430) as f32
   COO, on a local-filesystem object store under ``build/``. Reads:
   ``get_device`` full, ``read_device`` of X[0:100], ``read_many(...,
   device="cuda")``, COO full and COO X[1]. Every launch counter is set to 0
   just before these reads and read just after; each kernel of the read
   path must have run, ``unshuffle``'s register variant and
   ``block_gather``'s TMA variant among them. Each result is then checked
   byte for byte against the host ``read`` / ``read_slice`` with the CUDA
   unshuffle hook taken out;
5. the training feed:
   (a) one epoch of ``StreamLoader(store, "ffhq", batch_size=16, window=4,
   seed=0, device="cuda")`` over the FTSF tensor of phase 4, every batch a
   CUDA tensor byte-identical to the host loader's batch of the same step;
   then ``store.ingest`` appends 16 images and ``loader.reopen()`` must
   stream an epoch that covers every row once, its first batch equal to a
   fresh host loader's;
   (b) three steps of ``compressed_grad_mean`` with error feedback over the
   per-pod gradient tree of granite-3-8b (``src/repro/configs/
   granite_3_8b.py``: d_model 4096, 32 heads, 8 KV heads, head_dim 128,
   d_ff 12800, vocab 49155, untied embeddings) at full width, depth cut to
   L = 4 of 40 layers (``--layers``), 2 pods, bf16 gradients, ratio 0.05,
   (8, 128) blocks. Step 1 (dyadic gradients) must equal the same call on
   the CPU byte for byte; steps 2-3 (row-sparse Gaussian gradients) are held
   to ``decoded + residual == e``, the top-k norm order and the wire-ratio
   formula. ``block_norms``, ``block_gather`` and ``block_scatter`` must
   have launched on this path;
6. serving: granite-3-8b (``src/repro/configs/granite_3_8b.py``) at its
   published widths, bf16, depth cut to L = 4 of 40 layers (``--layers``;
   the save runs through the host's zlib within the run's time limit), with
   random weights from a seeded ``torch.Generator`` on the card. They are
   saved with ``store.models("granite-3-8b").save`` under ``zlib:1+shuffle``
   on a local-filesystem store under ``build/``, then cold-loaded onto the
   card with ``ModelRepo.load(template, device="cuda")``, the counted path:
   ``block_gather`` and ``unshuffle`` (its register variant, itemsize 2)
   must launch, and every leaf must equal the saved one byte for byte. The
   two kernels are then held to their plain versions at every shape the
   load gave them, and timed at the largest. One request's prefill logits
   (32 tokens) are held to the port's own forward on the CPU (max|d| <=
   2e-2 max|logits|; equal argmax wherever the CPU's top-1 margin exceeds
   2 max|d|); that request through ``ServeEngine`` (1 slot) must equal the
   offline prefill + decode loop token for token; and 8 requests (prompts
   of 16-128 tokens) through 4 slots must each finish with 32 tokens (how
   many agree with their solo runs is printed, not gated). Prints save and
   cold-load seconds and GB/s, a profiled load's idle share, prefill ms,
   decode tokens/s at 4 slots and peak device memory;
7. print the card's name and power limit, one JSON line of per-kernel
   numbers (launches per path: read, stream, compress, serve), and as the
   last line ``{"ok": true, "device": {...}}``.

It imports nothing of jax or of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
DUP_TOL = 1e-6             # scatter-add of duplicate float indices
NORM_RTOL = 1e-5           # block_norms of non-dyadic data: summation order
READ_KERNELS = ("block_gather", "unshuffle", "coo_scatter")
COMPRESS_KERNELS = ("block_norms", "block_gather", "block_scatter")
REPLACES = {"block_gather": "src/repro/kernels/block_gather.py:32",
            "unshuffle": "src/repro/kernels/unshuffle.py:31",
            "coo_scatter": "src/repro/kernels/coo_scatter.py:38",
            "block_norms": "src/repro/kernels/block_norms.py:22",
            "block_scatter": "src/repro/kernels/block_scatter.py:30"}
# gradient compression of the training feed: 2 pods, ratio 0.05, (8, 128)
PODS, RATIO, BLOCK = 2, 0.05, (8, 128)


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images", type=int, default=256,
                   help="FFHQ-like images of 3x1024x1024 f32 (default 256)")
    p.add_argument("--layers", type=int, default=4,
                   help="granite-3-8b layers in the gradient tree and the "
                        "served model (default 4 of 40; widths are never cut)")
    return p.parse_args()


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# -- comparison and timing ----------------------------------------------------

def max_abs_err(a, b) -> float:
    """Max |a - b| over two same-shape tensors (0.0 when byte-identical)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype mismatch {tuple(a.shape)} {a.dtype} vs "
             f"{tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0.0
    if a.dtype == torch.bool:
        return float((a != b).any())
    if a.dtype in (torch.uint16, torch.uint32, torch.uint64):
        a, b = a.to(torch.int64), b.to(torch.int64)
    if a.is_complex():
        return float((a.to(torch.complex128) - b.to(torch.complex128)).abs().max())
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def same_bytes(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


SAMPLES = 5  # timing samples per measurement; the median is reported


def time_ms(fn, iters: int):
    """(median, min, max) over SAMPLES samples of the device time of ``fn``
    in ms, each sample the mean of ``iters`` back-to-back calls between two
    CUDA events, after one warm-up call."""
    return time_turns_ms([fn], iters)[0]


def time_pair_ms(fn_a, fn_b, iters: int):
    """time_ms of two functions over the same window: their samples
    alternate (a, b, a, b, ...), so a drift of the card hits both alike."""
    return tuple(time_turns_ms([fn_a, fn_b], iters))


def time_turns_ms(fns, iters: int):
    """time_ms of each of ``fns``, their samples taken in turns."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    means = [[] for _ in fns]
    for _ in range(SAMPLES):
        for fn, acc in zip(fns, means):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            acc.append(start.elapsed_time(end) / iters)
    out = []
    for acc in means:
        acc.sort()
        out.append((acc[len(acc) // 2], acc[0], acc[-1]))
    return out


def wall_ms(fn, reps: int):
    """(median, min, max) host wall ms of ``fn`` (which ends synchronised)
    over ``reps`` calls, after one warm-up call."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    return walls[len(walls) // 2], walls[0], walls[-1]


def spread(t) -> str:
    return f"{t[0]!r} ms (min {t[1]!r}, max {t[2]!r})"


def device_ms_per_call(torch, fn, iters: int):
    """Device time per call of ``fn`` in ms from torch.profiler: the device
    rows' self time over ``iters`` calls, and each row's name, count and
    ms per call. (None, []) when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, names = 0.0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            total_us += us
            names.append(f"{e.key[:80]} x{e.count}: {us / 1e3 / iters!r} ms")
    if total_us == 0:
        return None, []
    return total_us / 1e3 / iters, names


def forced_variant(mod, which, fn):
    """``fn()`` with ``mod``'s variant chooser fixed to ``which``, to time one
    variant at a shape the chooser gives to another."""
    chooser = mod.variant
    mod.variant = lambda *args: which
    try:
        return fn()
    finally:
        mod.variant = chooser


def reset_counts(kern) -> None:
    """Every launch counter, and the per-variant counts, to 0."""
    kern.reset_launch_counts()
    for mod in (kern.unshuffle, kern.block_gather):
        for key in mod.variant_launches:
            mod.variant_launches[key] = 0


def variant_counts(kern) -> dict:
    return {"unshuffle": dict(kern.unshuffle.variant_launches),
            "block_gather": dict(kern.block_gather.variant_launches)}


# -- phase 2: kernels against their plain versions ----------------------------

SHAPES_BLOCKS = [((16, 128), (8, 128)), ((32, 256), (8, 128)),
                 ((24, 384), (8, 128)), ((64, 128), (16, 64)),
                 ((9, 130), (4, 64)), ((7, 1000), (1, 1000)),
                 ((5, 333), (1, 333)), ((3, 17), (2, 5))]


def _rand(torch, rng, shape, dtype, dev):
    """Seeded values of ``dtype`` on ``dev`` (float-exact small integers for
    f16/bf16 so that sums of duplicates are exact in any order)."""
    import numpy as np
    x = rng.standard_normal(shape)
    if dtype == torch.bool:
        return torch.from_numpy(x > 0).to(dev)
    if dtype in (torch.float16, torch.bfloat16):
        return torch.from_numpy(np.round(x * 4)).to(dev, dtype)
    if dtype.is_complex:
        y = rng.standard_normal(shape)
        return torch.from_numpy(x + 1j * y).to(dev, dtype)
    if dtype.is_floating_point:
        return torch.from_numpy(x).to(dev, dtype)
    if dtype in (torch.uint16, torch.uint32, torch.uint64):
        return torch.from_numpy(np.abs(x * 1000).astype(np.int64)).to(dev).to(
            {torch.uint16: torch.int16, torch.uint32: torch.int32,
             torch.uint64: torch.int64}[dtype]).view(dtype)
    return torch.from_numpy((x * 50).astype(np.int64)).to(dev, dtype)


UNSHUFFLE_NS = (1, 15, 16, 17, 4093, 65543, 3 * 2 ** 20)
# storage offsets of the planes: with the odd n above, every residue of a
# plane row's address mod 8 (the register variant's load alignments)
UNSHUFFLE_OFFSETS = (0, 1, 2, 4, 5)
# items of the frame of one 3x1024x1024 f32 chunk: the frame holds the whole
# part file, the chunk's 12 MiB and about 1.1 KiB of the file's own
FRAME_ITEMS = 3146018


def check_gather(torch, kern, x, ids, bs, what):
    """block_gather of ``x`` equals its plain version byte for byte."""
    got = kern.block_gather.launch(x, ids, bs)
    want = kern.block_gather.plain(x.contiguous(), ids, bs)
    if not same_bytes(got, want):
        fail(f"block_gather {tuple(x.shape)} {bs} {what}: max diff "
             f"{max_abs_err(got, want)}")


def check_kernels(torch, np, kern, main):
    """Sweeps + main-path shapes; returns {kernel: max_abs_err at main path}."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    reset_counts(kern)
    gather_dtypes = [torch.float32, torch.bfloat16, torch.int32, torch.float64,
                     torch.int8, torch.bool, torch.complex64, torch.complex128,
                     torch.uint16, torch.float16]
    n = 0
    for shape, bs in SHAPES_BLOCKS:
        gh, gw = -(-shape[0] // bs[0]), -(-shape[1] // bs[1])
        nb = gh * gw
        for dtype in gather_dtypes:
            x = _rand(torch, rng, shape, dtype, dev)
            for ids_np in (rng.choice(nb + 1, size=min(nb + 1, 6), replace=False),
                           np.array([nb + 5, -1, 0, nb - 1])):
                ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
                check_gather(torch, kern, x, ids, bs, f"{dtype} ids={ids_np}")
                n += 1
            # unaligned start: a contiguous view one element into its storage
            xs = _rand(torch, rng, (shape[0] * shape[1] + 1,), dtype,
                       dev)[1:].view(shape)
            ids = torch.from_numpy(rng.choice(nb, size=min(nb, 4),
                                              replace=False).astype(np.int32)).to(dev)
            check_gather(torch, kern, xs, ids, bs, f"{dtype} unaligned")
            n += 1
    # the TMA ring's cases: one 12 MiB tile (K = 1), K not a multiple of
    # the SM count, several tiles per row, tiles of several 32 KiB pieces
    # with a short last one, x 4 bytes off alignment, ids out of range
    g = torch.Generator(device=dev).manual_seed(5)
    row = 3 * 1024 * 1024
    for shape, bs, k in (((2, row), (1, row), 1), ((300, 4096), (1, 4096), 133),
                         ((64, 8192), (1, 2048), 257), ((40, 30000), (1, 10000), 61),
                         ((17, 100000), (1, 50000), 35)):
        flat = torch.rand(shape[0] * shape[1] + 1, generator=g, device=dev)
        nb = shape[0] * (shape[1] // bs[1])
        ids_sets = [torch.randint(0, nb, (k,), generator=g, device=dev,
                                  dtype=torch.int32),
                    torch.randint(-3, nb + 3, (k,), generator=g, device=dev,
                                  dtype=torch.int32)]
        for x in (flat[:-1].view(shape), flat[1:].view(shape)):  # 4 B off
            for ids in ids_sets:
                check_gather(torch, kern, x, ids, bs, f"K={k}")
                n += 1
        del flat
    used = dict(kern.block_gather.variant_launches)
    if min(used.values()) <= 0:
        fail(f"the block_gather sweep did not reach every variant: {used}")
    log(f"[check] block_gather sweep: {n} cases, max diff 0; launches by "
        f"variant {json.dumps(used)}")

    n = 0
    reset_counts(kern)
    for it in range(1, kern.unshuffle.MAX_ITEMSIZE + 1):
        for cols in UNSHUFFLE_NS:
            flat = torch.randint(0, 256, (it * cols + max(UNSHUFFLE_OFFSETS),),
                                 generator=g, device=dev, dtype=torch.uint8)
            for off in UNSHUFFLE_OFFSETS:  # contiguous, all but 0 misaligned
                planes = flat[off:off + it * cols].view(it, cols)
                got = kern.unshuffle.launch(planes)
                if not torch.equal(got, kern.unshuffle.plain(planes)):
                    fail(f"unshuffle itemsize {it} n {cols} offset {off}: max "
                         f"diff {max_abs_err(got, kern.unshuffle.plain(planes))}")
                n += 1
            del flat
    used = dict(kern.unshuffle.variant_launches)
    if min(used.values()) <= 0:
        fail(f"the unshuffle sweep did not reach every variant: {used}")
    log(f"[check] unshuffle sweep: {n} cases (itemsize 1-32 x n {UNSHUFFLE_NS} "
        f"x offset {UNSHUFFLE_OFFSETS}), max diff 0; launches by variant "
        f"{json.dumps(used)}")

    n = 0
    dup_worst = 0.0
    scatter_dtypes = list(kern.coo_scatter.KINDS) + [torch.uint16, torch.uint32,
                                                     torch.uint64]
    for size, k in ((512, 17), (1024, 100), (640, 1), (130, 9), (1, 1),
                    (4099, 3000), (3, 0)):
        for dtype in scatter_dtypes:
            vals = _rand(torch, rng, (k,), dtype, dev)
            uniq = rng.permutation(size)[:k] if k <= size else None
            if uniq is not None and len(uniq) == k:
                pad = np.where(rng.random(k) < 0.2, size + 7, uniq)  # drops
                for idx_np in (uniq, pad, uniq - size):  # -size..-1 wrap
                    idx = torch.from_numpy(idx_np.astype(np.int64)).to(dev)
                    for unique in (True, False):
                        got = kern.coo_scatter.launch(idx, vals, size, unique=unique)
                        want = kern.coo_scatter.plain(idx, vals, size, unique=unique)
                        if not same_bytes(got, want):
                            fail(f"coo_scatter {size} {k} {dtype} unique={unique}: "
                                 f"max diff {max_abs_err(got, want)}")
                        n += 1
            dup = torch.from_numpy(rng.integers(0, max(1, size // 4 + 1), k)
                                   .astype(np.int64)).to(dev)
            got = kern.coo_scatter.launch(dup, vals, size)
            want = kern.coo_scatter.plain(dup, vals, size)
            inexact = dtype.is_complex or (dtype.is_floating_point and dtype
                                           not in (torch.float16, torch.bfloat16))
            if inexact:
                err = max_abs_err(got, want)
                if not torch.allclose(got, want, rtol=DUP_TOL, atol=DUP_TOL):
                    fail(f"coo_scatter duplicates {size} {k} {dtype}: {err}")
                dup_worst = max(dup_worst, err)
            elif not same_bytes(got, want):
                fail(f"coo_scatter duplicates {size} {k} {dtype}: "
                     f"max diff {max_abs_err(got, want)}")
            n += 1
    log(f"[check] coo_scatter sweep: {n} cases, max diff 0 except duplicate "
        f"float adds: {dup_worst!r} (tolerance rtol=atol={DUP_TOL})")

    # the main path's shapes
    errs = {}
    x, ids = main["gather"]
    reset_counts(kern)
    got = kern.block_gather.launch(x, ids, (1, x.shape[1]))
    want = kern.block_gather.plain(x, ids, (1, x.shape[1]))
    errs["block_gather"] = max_abs_err(got, want)
    del got, want
    planes = main["unshuffle"]
    errs["unshuffle"] = max_abs_err(kern.unshuffle.launch(planes),
                                    kern.unshuffle.plain(planes))
    log(f"[check] variants taken at the main-path shapes: "
        f"{json.dumps(variant_counts(kern))}")
    idx, vals, size = main["coo_scatter"]
    got = kern.coo_scatter.launch(idx, vals, size, unique=True)
    want = kern.coo_scatter.plain(idx, vals, size, unique=True)
    errs["coo_scatter"] = max_abs_err(got, want)
    del got, want
    torch.cuda.synchronize()
    for name, err in errs.items():
        log(f"[check] {name} at main-path shape: max abs err {err!r}")
        if err != 0.0:
            fail(f"{name} differs from its plain version at the main-path shape")
    return errs


def _dyadic(torch, rng, shape, dtype, dev):
    """Integers in [-3, 3] / 8 as ``dtype``: exact in f16/bf16, and their
    squares sum exactly in f32 in any order."""
    x = rng.integers(-3, 4, shape) / 8
    return torch.from_numpy(x).to(dev, dtype)


NORM_CASES = SHAPES_BLOCKS + [((64, 256), (8, 128)), ((33, 1000), (8, 128)),
                              ((64, 128), (1, 128)), ((300, 130), (1, 130)),
                              ((7, 4096), (1, 4096)),
                              ((2, 100000), (1, 100000)),  # one block per tile
                              ((5, 33333), (1, 33333))]


def check_compress_kernels(torch, np, kern, main):
    """Sweeps + main-path shapes of block_norms and block_scatter; returns
    {kernel: max_abs_err at the main path's shape}."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    n, worst = 0, 0.0
    for shape, bs in NORM_CASES:
        for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.float64):
            xd = _dyadic(torch, rng, shape, dtype, dev)
            got = kern.block_norms.launch(xd, bs)
            if not same_bytes(got, kern.block_norms.plain(xd, bs)):
                fail(f"block_norms dyadic {shape} {bs} {dtype}: max diff "
                     f"{max_abs_err(got, kern.block_norms.plain(xd, bs))}")
            xr = _rand(torch, rng, shape, dtype, dev)
            # an unaligned start: a contiguous view one element in
            xs = _rand(torch, rng, (shape[0] * shape[1] + 1,), dtype,
                       dev)[1:].view(shape)
            for x in (xr, xs):
                got = kern.block_norms.launch(x, bs)
                want = kern.block_norms.plain(x.contiguous(), bs)
                if not torch.allclose(got, want, rtol=NORM_RTOL, atol=0):
                    fail(f"block_norms {shape} {bs} {dtype}: max diff "
                         f"{max_abs_err(got, want)}")
                worst = max(worst, float(((got - want).abs() / want.abs()
                                          .clamp_min(1e-30)).max()))
            n += 3
    log(f"[check] block_norms sweep: {n} cases, dyadic exact, worst relative "
        f"diff {worst!r} (tolerance rtol={NORM_RTOL}, atol=0)")

    n = 0
    scatter_dtypes = [torch.float32, torch.bfloat16, torch.int32, torch.float64,
                      torch.int8, torch.bool, torch.complex64,
                      torch.complex128, torch.uint16, torch.float16]
    for shape, bs in SHAPES_BLOCKS + [((64, 256), (8, 128)),
                                      ((64, 128), (1, 128))]:
        gh, gw = -(-shape[0] // bs[0]), -(-shape[1] // bs[1])
        nb = gh * gw
        id_sets = [rng.choice(nb + 3, size=min(nb, 6), replace=False)]
        if nb >= 2:  # -1 wraps to the last tile, -nb-1 and nb+5 drop
            id_sets.append(np.array([-1, 0, -nb - 1, nb + 5]))
        for dtype in scatter_dtypes:
            for ids_np in id_sets:
                ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
                base = _rand(torch, rng, shape, dtype, dev)
                blocks = _rand(torch, rng, (len(ids_np),) + bs, dtype, dev)
                want = kern.block_scatter.plain(base, ids, blocks)
                got = kern.block_scatter.launch(base, ids, blocks)
                inplace = base.clone()
                kern.block_scatter.launch(inplace, ids, blocks, inplace=True)
                xs = _rand(torch, rng, (shape[0] * shape[1] + 1,), dtype,
                           dev)[1:].view(shape)
                got_u = kern.block_scatter.launch(xs, ids, blocks)
                want_u = kern.block_scatter.plain(xs.contiguous(), ids, blocks)
                for g, w, what in ((got, want, ""), (inplace, want, " in place"),
                                   (got_u, want_u, " unaligned")):
                    if not same_bytes(g, w):
                        fail(f"block_scatter{what} {shape} {bs} {dtype} "
                             f"ids={ids_np}: max diff {max_abs_err(g, w)}")
                n += 3
        # blocks of another dtype are cast to base's
        ids = torch.from_numpy(id_sets[0].astype(np.int32)).to(dev)
        base = _rand(torch, rng, shape, torch.bfloat16, dev)
        blocks = _rand(torch, rng, (len(ids),) + bs, torch.float32, dev)
        if not same_bytes(kern.block_scatter.launch(base, ids, blocks),
                          kern.block_scatter.plain(base, ids, blocks)):
            fail(f"block_scatter cast f32 -> bf16 {shape} {bs}")
        n += 1
    log(f"[check] block_scatter sweep: {n} cases, max diff 0")

    errs = {}
    x = main["norms"]
    got, want = kern.block_norms.launch(x, BLOCK), kern.block_norms.plain(x, BLOCK)
    errs["block_norms"] = max_abs_err(got, want)
    if not torch.allclose(got, want, rtol=NORM_RTOL, atol=0):
        fail(f"block_norms at the main-path shape: max diff {errs['block_norms']}")
    xd = _dyadic(torch, rng, tuple(x.shape), torch.float32, dev)
    if not same_bytes(kern.block_norms.launch(xd, BLOCK),
                      kern.block_norms.plain(xd, BLOCK)):
        fail("block_norms of dyadic data at the main-path shape is not exact")
    del got, want, xd
    base, ids, blocks = main["scatter"]
    want = kern.block_scatter.plain(base, ids, blocks)
    inplace = base.clone()
    kern.block_scatter.launch(inplace, ids, blocks, inplace=True)
    errs["block_scatter"] = max(
        max_abs_err(kern.block_scatter.launch(base, ids, blocks), want),
        max_abs_err(inplace, want))
    del want, inplace
    torch.cuda.synchronize()
    log(f"[check] block_norms at main-path shape {tuple(x.shape)}: max abs err "
        f"{errs['block_norms']!r} (dyadic: exact)")
    log(f"[check] block_scatter at main-path shape, in place and with its "
        f"copy of base: max abs err {errs['block_scatter']!r}")
    if errs["block_scatter"] != 0.0:
        fail("block_scatter differs from its plain version at the main-path shape")
    return errs


def main_shapes(torch, np, n_images, coo_size, coo_nnz):
    """Kernel operands at the shapes the main path gives them."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    row = 3 * 1024 * 1024
    x = torch.rand((n_images, row), generator=g, device=dev)
    ids = torch.randperm(n_images, generator=g, device=dev).to(torch.int32)
    planes = torch.randint(0, 256, (4, row), generator=g, device=dev,
                           dtype=torch.uint8)  # one f32 chunk's byte planes
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.choice(coo_size, coo_nnz, replace=False)
                           .astype(np.int64)).to(dev)
    vals = torch.rand(coo_nnz, generator=g, device=dev)
    # one pod's e of granite-3-8b's largest leaf, blocks/mlp/w_gate at
    # L = 4: (4 * 4096, 12800) f32, and its top 5 % of (8, 128) tiles
    e = torch.randn((4 * 4096, 12800), generator=g, device=dev)
    n_tiles = (e.shape[0] // BLOCK[0]) * (e.shape[1] // BLOCK[1])
    k = max(1, int(n_tiles * RATIO))
    sel = torch.randperm(n_tiles, generator=g, device=dev)[:k].to(torch.int32)
    tiles = torch.randn((k,) + BLOCK, generator=g, device=dev)
    return {"gather": (x, ids), "unshuffle": planes,
            "coo_scatter": (idx, vals, coo_size), "norms": e,
            "scatter": (torch.zeros_like(e), sel, tiles)}


def time_kernels(torch, kern, main):
    """{kernel: (ms, plain_ms, library_ms, bound_ms)} at main-path shapes,
    each time a (median, min, max) triple; plus {kernel: (device ms per
    launch, library device ms per call)} from torch.profiler for the two
    kernels redesigned for Hopper."""
    out, dev_ms = {}, {}
    x, ids = main["gather"]
    bs = (1, x.shape[1])
    ids64 = ids.to(torch.int64)
    tile_bytes = x.shape[1] * x.element_size()
    bound = (2 * ids.numel() * tile_bytes + ids.numel() * 4) / HBM_BYTES_PER_S * 1e3
    def gather_tiles():  # the word-copy variant at the same shape
        return forced_variant(kern.block_gather, "tiles",
                              lambda: kern.block_gather.launch(x, ids, bs))

    k_t, tiles_t, lib_t = time_turns_ms(
        [lambda: kern.block_gather.launch(x, ids, bs), gather_tiles,
         lambda: x.index_select(0, ids64)], 10)
    out["block_gather"] = (k_t, time_ms(lambda: kern.block_gather.plain(x, ids, bs), 5),
                           lib_t, bound)
    dev_ms["block_gather"] = (
        device_ms_per_call(torch, lambda: kern.block_gather.launch(x, ids, bs), 10),
        device_ms_per_call(torch, lambda: x.index_select(0, ids64), 10))
    tiles_dev = device_ms_per_call(torch, gather_tiles, 10)[0]
    log(f"[time] block_gather variants at the main shape, in turns (TMA ring, "
        f"word copies, index_select): TMA ring {spread(k_t)}, word copies "
        f"{spread(tiles_t)}, index_select {spread(lib_t)}; device ms per call "
        f"(torch.profiler): TMA ring {dev_ms['block_gather'][0][0]!r}, word "
        f"copies {tiles_dev!r}, index_select {dev_ms['block_gather'][1][0]!r}")
    # a yardstick beside the bound: one contiguous device-to-device copy_
    # of all of x, the same bytes in and out
    dst = torch.empty_like(x)
    log(f"[time] block_gather's ceiling, copy_ of the same {x.numel() * 4} B "
        f"in one contiguous copy: {spread(time_ms(lambda: dst.copy_(x), 10))}, "
        f"device {device_ms_per_call(torch, lambda: dst.copy_(x), 10)[0]!r} ms")
    del dst
    planes = main["unshuffle"]
    bound = 2 * planes.numel() / HBM_BYTES_PER_S * 1e3
    k_t, lib_t = time_pair_ms(lambda: kern.unshuffle.launch(planes),
                              lambda: planes.t().contiguous(), 50)
    out["unshuffle"] = (k_t, time_ms(lambda: kern.unshuffle.plain(planes), 20),
                        lib_t, bound)
    dev_ms["unshuffle"] = (
        device_ms_per_call(torch, lambda: kern.unshuffle.launch(planes), 100),
        device_ms_per_call(torch, lambda: planes.t().contiguous(), 100))
    # the same launches with the planes out of L2: eight sets in turn (96
    # MiB of planes, and as many items, against the 50 MB L2)
    cold = [torch.randint(0, 256, planes.shape, device=planes.device,
                          dtype=torch.uint8) for _ in range(8)]
    turn = [0]

    def next_planes():
        turn[0] += 1
        return cold[turn[0] % len(cold)]

    k_cold = device_ms_per_call(torch, lambda: kern.unshuffle.launch(next_planes()), 96)
    l_cold = device_ms_per_call(torch, lambda: next_planes().t().contiguous(), 96)
    log(f"[time] unshuffle device time per call with its planes out of L2 "
        f"(torch.profiler): kernel {k_cold[0]!r} ms, library {l_cold[0]!r} ms, "
        f"bound {bound!r} ms (bytes)")
    del cold
    idx, vals, size = main["coo_scatter"]
    eb = vals.element_size()
    bound = (size * eb + idx.numel() * (8 + eb)) / HBM_BYTES_PER_S * 1e3
    out["coo_scatter"] = (
        time_ms(lambda: kern.coo_scatter.launch(idx, vals, size, unique=True), 10),
        time_ms(lambda: kern.coo_scatter.plain(idx, vals, size, unique=True), 5),
        time_ms(lambda: torch.zeros(size, device=vals.device).index_put_(
            (idx,), vals, accumulate=True), 10),
        bound)
    e = main["norms"]
    m, n = e.shape
    gh, gw = m // BLOCK[0], n // BLOCK[1]
    bound = (e.numel() * 4 + gh * gw * 4) / HBM_BYTES_PER_S * 1e3
    out["block_norms"] = (
        time_ms(lambda: kern.block_norms.launch(e, BLOCK), 50),
        time_ms(lambda: kern.block_norms.plain(e, BLOCK), 5),
        time_ms(lambda: torch.linalg.vector_norm(
            e.view(gh, BLOCK[0], gw, BLOCK[1]), dim=(1, 3),
            dtype=torch.float32), 50), bound)
    base, sel, tiles = main["scatter"]
    ti, tj = (sel // gw).to(torch.int64), (sel % gw).to(torch.int64)
    grid = base.view(gh, BLOCK[0], gw, BLOCK[1]).permute(0, 2, 1, 3)
    # the compressor's call: in place into its zero buffer; the least
    # traffic is the tiles read and written once, plus the ids
    bound = (2 * tiles.numel() * 4 + sel.numel() * 4) / HBM_BYTES_PER_S * 1e3
    out["block_scatter"] = (
        time_ms(lambda: kern.block_scatter.launch(base, sel, tiles,
                                                  inplace=True), 30),
        time_ms(lambda: kern.block_scatter.plain(base, sel, tiles,
                                                 inplace=True), 5),
        time_ms(lambda: grid.index_put_((ti, tj), tiles), 30), bound)
    # block_gather at the compressor's shape: the K top tiles of one pod's
    # w_gate at L = 4 (the (8, 128) tile variant); tiles read and written
    # once, plus the ids
    egrid = e.view(gh, BLOCK[0], gw, BLOCK[1]).permute(0, 2, 1, 3)
    g_bound = (2 * tiles.numel() * 4 + sel.numel() * 4) / HBM_BYTES_PER_S * 1e3
    reset_counts(kern)
    g_ms = time_ms(lambda: kern.block_gather.launch(e, sel, BLOCK), 30)
    g_lib = time_ms(lambda: egrid[ti, tj], 30)
    log(f"[time] block_gather at the compress shape, K = {sel.numel()} "
        f"{BLOCK} f32 tiles of ({m}, {n}), launches by variant "
        f"{json.dumps(kern.block_gather.variant_launches)}: kernel "
        f"{spread(g_ms)}, library (permuted view [ti, tj]) {spread(g_lib)}, "
        f"bound {g_bound!r} ms (bytes)")
    # with its copy of base (no caller on the main path): every element of
    # out is written once and only base's elements outside the tiles need
    # reading, so at least base read and out written, plus the ids
    copy_bound = (2 * base.numel() * 4 + sel.numel() * 4) / HBM_BYTES_PER_S * 1e3
    copy_ms = time_ms(lambda: kern.block_scatter.launch(base, sel, tiles), 30)
    copy_lib_ms = time_ms(lambda: base.clone().view(gh, BLOCK[0], gw, BLOCK[1])
                          .permute(0, 2, 1, 3).index_put_((ti, tj), tiles), 30)
    log(f"[time] block_scatter with its copy of base: kernel {spread(copy_ms)}, "
        f"clone + index_put_ {spread(copy_lib_ms)}, bound {copy_bound!r} ms (bytes)")
    # the untied unembedding's rows (49155 f32) take single-element loads
    u = torch.randn((4096, 49155), device=e.device)
    u_bound = (u.numel() * 4 + 512 * 385 * 4) / HBM_BYTES_PER_S * 1e3
    log(f"[time] block_norms on unembed (4096, 49155) f32, unvectorised "
        f"loads: {spread(time_ms(lambda: kern.block_norms.launch(u, BLOCK), 20))}, "
        f"bound {u_bound!r} ms (bytes)")
    del u
    for name, (ms, plain_ms, lib_ms, bound_ms) in out.items():
        mode = " (in place)" if name == "block_scatter" else ""
        log(f"[time] {name}{mode}: kernel {spread(ms)}, plain {spread(plain_ms)}, "
            f"library {spread(lib_ms)}, bound {bound_ms!r} ms (bytes)")
    for name, ((k_ms, k_names), (l_ms, l_names)) in dev_ms.items():
        log(f"[time] {name} device time per call (torch.profiler): kernel "
            f"{k_ms!r} ms {k_names}, library {l_ms!r} ms {l_names}")
    return out, {name: (k[0], lib[0]) for name, (k, lib) in dev_ms.items()}


def time_unshuffle_hook(torch, np, kern, ops):
    """The frame-decode hook on one f32 chunk's frame, called with ``out=``
    as byte_unshuffle calls it, against the other ways to the same bytes,
    in turns in this process: wall and device time per chunk (device rows
    of torch.profiler by operation). Then the split of the hook's parts and
    of the pinned alternatives.

    The ways: the hook (one H2D by ``unshuffle.upload_planes`` straight from
    the read-only planes, the register variant, one D2H into ``out``); the
    same with torch's H2D; that with the shared variant; an earlier form of
    the hook (the planes landed in rows padded to 16 items, which torch
    does through a padding copy on the card, then the register variant on
    aligned rows); and the earliest hook's pinned staging both ways with
    the copy byte_unshuffle made after it."""
    dev = torch.device("cuda")
    n = FRAME_ITEMS
    planes = np.frombuffer(np.random.default_rng(2).integers(
        0, 256, 4 * n, dtype=np.uint8).tobytes(), dtype=np.uint8).reshape(4, n)
    # read-only planes, as decoded: torch wraps them with a warning, which
    # only says that torch could write them
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t_planes = torch.from_numpy(planes)
    # a copy that numpy owns, to tell the source buffer's part in the H2D
    # from the route's
    t_copy = torch.from_numpy(planes.copy())
    want = np.ascontiguousarray(planes.T)
    out = np.empty((n, 4), dtype=np.uint8)
    t_out = torch.from_numpy(out)
    pitch = -(-n // 16) * 16
    reps = 20
    sync = torch.cuda.synchronize

    def hook():
        ops.unshuffle_host(planes, device="cuda", out=out)

    def torch_h2d():
        rows = torch.empty((4, n), dtype=torch.uint8, device=dev)
        rows.copy_(t_planes)
        t_out.copy_(kern.unshuffle.launch(rows))

    def shared():
        forced_variant(kern.unshuffle, "shared", torch_h2d)

    def padded_on_card():
        rows = torch.empty((4, pitch), dtype=torch.uint8, device=dev)
        rows[:, :n].copy_(t_planes)
        t_out.copy_(kern.unshuffle.launch(rows)[:n])

    def staged_steps():
        src = torch.empty(planes.shape, dtype=torch.uint8, pin_memory=True)
        src.numpy()[...] = planes
        items = kern.unshuffle.launch(src.to(dev, non_blocking=True))
        host = torch.empty(items.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(items)
        out[...] = host.numpy()

    ways = {"hook": hook, "torch H2D": torch_h2d,
            "torch H2D, shared variant": shared,
            "padded on the card": padded_on_card,
            "pinned staging + copy": staged_steps}
    walls = {name: [] for name in ways}
    for name in list(ways) + list(reversed(ways)):
        out[...] = 0
        walls[name].append(wall_ms(ways[name], reps))
        if not np.array_equal(out, want):
            fail(f"unshuffle hook way {name!r} differs from the numpy transpose")
    if not np.array_equal(ops.unshuffle_host(planes, device="cuda"), want):
        fail("unshuffle_host without out= differs from the numpy transpose")
    per_way = []
    for name, fn in ways.items():
        reset_counts(kern)
        d_ms, rows_seen = device_ms_per_call(torch, fn, 10)
        per_way.append(f"{name}: wall {'; '.join(spread(t) for t in walls[name])}, "
                       f"device {d_ms!r} ms per chunk {rows_seen}, variants "
                       f"{json.dumps(kern.unshuffle.variant_launches)}")
    log(f"[time] unshuffle hook ways, one f32 chunk's frame ({n} items of 4 "
        f"bytes: the chunk and its part file's own bytes), in turns there and "
        f"back, wall median of {reps} per turn: " + " | ".join(per_way))

    rows = torch.empty((4, n), dtype=torch.uint8, device=dev)
    d_items = kern.unshuffle.launch(rows)
    src = torch.empty((4, n), dtype=torch.uint8, pin_memory=True)
    host = torch.empty((n, 4), dtype=torch.uint8, pin_memory=True)

    def upload():
        kern.unshuffle.upload_planes(planes, rows)
        sync()

    def kernel():
        kern.unshuffle.launch(rows)
        sync()

    def h2d_torch():
        rows.copy_(t_planes)
        sync()

    def h2d_copy():
        rows.copy_(t_copy)
        sync()

    def h2d_pinned():
        rows.copy_(src, non_blocking=True)
        sync()

    h2d_ways = {"upload_planes": upload, "torch copy_": h2d_torch,
                "torch copy_ from a numpy-owned copy": h2d_copy}
    h2d = {name: [] for name in h2d_ways}  # in turns there and back
    for name in list(h2d_ways) + list(reversed(h2d_ways)):
        h2d[name].append(wall_ms(h2d_ways[name], reps))
    log(f"[time] unshuffle hook's H2D from the pageable planes, in turns: "
        + "; ".join(f"{k} {' / '.join(spread(t) for t in v)}"
                    for k, v in h2d.items()))
    parts = {
        "H2D by upload_planes, from the pageable planes": h2d["upload_planes"][0],
        "kernel (launch + sync)": wall_ms(kernel, reps),
        "D2H into pageable out": wall_ms(lambda: t_out.copy_(d_items), reps),
    }
    alt = {
        "copy-in (planes -> pinned)": wall_ms(
            lambda: src.numpy().__setitem__(Ellipsis, planes), reps),
        "H2D (pinned)": wall_ms(h2d_pinned, reps),
        "D2H (pinned)": wall_ms(lambda: host.copy_(d_items), reps),
        "copy-out (pinned -> out)": wall_ms(
            lambda: out.__setitem__(Ellipsis, host.numpy()), reps),
    }
    log(f"[time] unshuffle hook split (wall, median of {reps}): "
        + "; ".join(f"{k} {spread(v)}" for k, v in parts.items())
        + f"; sum of medians {sum(v[0] for v in parts.values())!r} ms")
    log(f"[time] unshuffle hook, other transfers (wall, median of {reps}): "
        + "; ".join(f"{k} {spread(v)}" for k, v in alt.items())
        + f"; copy-in + pinned H2D {alt['copy-in (planes -> pinned)'][0] + alt['H2D (pinned)'][0]!r} ms, "
        f"pinned D2H + copy-out {alt['D2H (pinned)'][0] + alt['copy-out (pinned -> out)'][0]!r} ms")


def time_launch_path(torch, kern, build):
    """Host microseconds per call of the launch path's parts, and of a whole
    ``unshuffle`` launch on small planes (its kernel shorter than the host
    path, so the host sets the rate), without synchronising. The earlier
    forms (the ctypes function loaded and typed on every call, the
    ``torch.cuda.device`` context always entered) are timed beside the
    current ones."""
    import ctypes
    calls = 5000
    planes = torch.zeros((4, 4096), dtype=torch.uint8, device="cuda")
    args = kern.unshuffle._ARGTYPES

    def per_call_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    def typed_each_call():
        fn = getattr(build.load("unshuffle"), "rt_unshuffle")
        fn.restype = ctypes.c_int
        fn.argtypes = args

    def device_context():
        with torch.cuda.device(planes.device):
            pass

    def device_scope():
        with build.device_scope(planes):
            pass

    us = {"whole launch, unshuffle (4, 4096)": per_call_us(
              lambda: kern.unshuffle.launch(planes)),
          "function lookup, memoised": per_call_us(
              lambda: build.function("unshuffle", "rt_unshuffle", args)),
          "function lookup, typed on every call (earlier)": per_call_us(
              typed_each_call),
          "device_scope on the current card": per_call_us(device_scope),
          "torch.cuda.device on the current card (earlier)": per_call_us(
              device_context)}
    saved = (us["function lookup, typed on every call (earlier)"]
             - us["function lookup, memoised"]
             + us["torch.cuda.device on the current card (earlier)"]
             - us["device_scope on the current card"])
    log(f"[time] launch path, host us per call (mean of {calls}): "
        + "; ".join(f"{k} {v!r}" for k, v in us.items())
        + f"; saved per launch against the earlier forms {saved!r} us")


# -- phase 4: the main path ---------------------------------------------------

def main_path(torch, np, n_images, workdir):
    from repro_torch import kernels
    from repro_torch.core import DeltaTensorStore
    from repro_torch.data.synthetic import ffhq_like, uber_like
    from repro_torch.kernels import ops
    from repro_torch.lake import LocalFSObjectStore, set_unshuffle_kernel

    t0 = time.perf_counter()
    x = ffhq_like((n_images, 3, 1024, 1024), seed=0, dtype=np.float32)
    coo = uber_like((183, 24, 285, 430))
    log(f"[data] ffhq_like {x.shape} f32 {x.nbytes} B, uber_like {coo.shape} "
        f"nnz {coo.nnz}: {time.perf_counter() - t0:.1f} s")
    store = DeltaTensorStore(LocalFSObjectStore(str(workdir)), "paper",
                             compression="zlib+shuffle")
    t0 = time.perf_counter()
    store.put(x, tensor_id="ffhq", layout="ftsf", chunk_dims=3)
    store.put(coo, tensor_id="uber", layout="coo")
    log(f"[data] put: {time.perf_counter() - t0:.1f} s, stored "
        f"{store.tensor_bytes('ffhq')} B ffhq, {store.tensor_bytes('uber')} B uber")

    n_slice = min(100, max(1, n_images // 2))
    many = [("ffhq", [(n_images - 4, n_images)]), ("uber", [(2, 3)]),
            ("ffhq", [(0, 2)])]

    def read_slice_device(tid, slices):
        with store.open(tid) as ref:
            return ref.read_device(slices)

    reads = [  # (name, device read, host read)
        ("get_device ffhq", lambda: store.get_device("ffhq"),
         lambda: store.get("ffhq")),
        (f"read_device ffhq X[0:{n_slice}]",
         lambda: read_slice_device("ffhq", [(0, n_slice)]),
         lambda: store.get_slice("ffhq", [(0, n_slice)])),
        ("read_many ffhq+uber", lambda: store.read_many(many, device="cuda"),
         lambda: store.read_many(many)),
        ("get_device uber (COO)", lambda: store.get_device("uber"),
         lambda: store.get("uber")),
        ("read_device uber X[1] (COO)",
         lambda: read_slice_device("uber", [(1, 2)]),
         lambda: store.get_slice("uber", [(1, 2)])),
    ]

    torch.cuda.synchronize()
    reset_counts(kernels)
    results = []
    for name, fn, _ in reads:
        store.io.stats.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs = out if isinstance(out, list) else [out]
        nbytes = sum(o.numel() * o.element_size() for o in outs)
        for o in outs:
            if not o.is_cuda:
                fail(f"{name} returned a tensor on {o.device}")
        results.append(outs)
        stats = store.io_stats()
        log(f"[read] {name}: {wall!r} s, {nbytes} B, {nbytes / wall / 1e9!r} GB/s, "
            f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
            f"io_stats {json.dumps(stats, sort_keys=True, default=str)}")
    counts = kernels.launch_counts()
    variants = variant_counts(kernels)
    log(f"[read] launches during the read path: {json.dumps(counts)}; by "
        f"variant {json.dumps(variants)}")
    for name in READ_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the read path")
    for name, which in (("unshuffle", "register"), ("block_gather", "rows_tma")):
        if variants[name][which] <= 0:
            fail(f"the read path did not launch {name}'s {which} variant")
        log(f"[read] the read path launched {name}'s {which} variant "
            f"{variants[name][which]} times")

    # byte-for-byte against the host decode, with the numpy unshuffle
    set_unshuffle_kernel(None)
    try:
        from repro_torch.lake.device import to_torch
        for (name, _, hfn), outs in zip(reads, results):
            want = hfn()
            wants = want if isinstance(want, list) else [want]
            for o, w in zip(outs, wants):
                if not same_bytes(o, to_torch(w, "cuda")):
                    fail(f"{name}: device result differs from the host read")
            log(f"[verify] {name}: byte-identical to the host read")
        if not same_bytes(results[0][0], to_torch(x, "cuda")):
            fail("get_device ffhq differs from the written tensor")
    finally:
        set_unshuffle_kernel(None)
    del results
    profile_read(torch, store, reads[1])
    return store, counts


def profile_read(torch, store, read):
    """Device busy time of one more slice read under torch.profiler (after
    the counted run, so the profiler perturbs no number above)."""
    from repro_torch.kernels import ops
    from repro_torch.lake import set_unshuffle_kernel
    set_unshuffle_kernel(functools.partial(ops.unshuffle_host,
                                           device=store.device))
    name, fn, _ = read
    profile_call(torch, name, fn)
    set_unshuffle_kernel(None)


def profile_call(torch, name, fn):
    """Run ``fn`` once under torch.profiler, print its wall time, device
    busy time, idle share and top device operations, and return the device
    microseconds by operation name ({} when the profiler saw none)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, n_ops = {}, 0
    for e in prof.key_averages():
        # device-side rows only (kernels, memcpys, memsets): an operator's
        # row repeats the device time of what it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            busy_us[e.key] = us
            n_ops += e.count
    total_ms = sum(busy_us.values()) / 1e3
    top = sorted(busy_us.items(), key=lambda kv: -kv[1])[:6]
    if total_ms == 0:
        log(f"[profile] {name}: the profiler saw no device time (not measured)")
        return busy_us
    log(f"[profile] {name}: wall {wall!r} s (profiled), device busy "
        f"{total_ms!r} ms in {n_ops} device operations, idle share "
        f"{1 - total_ms / 1e3 / wall!r}; top: "
        + "; ".join(f"{k[:100]} {v / 1e3:.3f} ms" for k, v in top))
    return busy_us


# device operations of the compressed step by kernel, from their names
STEP_SPLIT = (("block_norms", ("norms_warp", "norms_block")),
              ("block_gather", ("gather_tiles", "gather_rows_tma")),
              ("block_scatter", ("scatter_tiles", "copy_words")),
              ("sort (top k)", ("sort",)))


# -- phase 5: the training feed ------------------------------------------------

def stream_path(torch, np, store, n_images):
    """5(a): one epoch of the FTSF tensor to the card through StreamLoader,
    held to the host loader; then ingest and reopen. Returns the launches
    of the loader's runs."""
    from repro_torch import kernels
    from repro_torch.data import StreamLoader
    from repro_torch.data.synthetic import ffhq_like
    from repro_torch.kernels import ops
    from repro_torch.lake import set_unshuffle_kernel
    from repro_torch.lake.device import to_torch

    def cuda_hook(on):
        set_unshuffle_kernel(functools.partial(ops.unshuffle_host,
                                               device=store.device)
                             if on else None)

    kw = dict(batch_size=16, window=4, seed=0, epochs=1)
    # the host reference loaders prefetch nothing beyond the batch they
    # yield, so no decode of theirs runs on into a later path's counts
    host_kw = dict(kw, window=1)
    cuda_hook(True)
    torch.cuda.synchronize()
    store.io.stats.reset()
    reset_counts(kernels)
    loader = StreamLoader(store, "ffhq", device="cuda", **kw)
    batches, waits = [], []
    t0 = time.perf_counter()
    it = iter(loader)
    while True:
        tw = time.perf_counter()
        b = next(it, None)
        if b is None:
            break
        torch.cuda.synchronize()
        waits.append(time.perf_counter() - tw)
        if not b["data"].is_cuda:
            fail(f"StreamLoader batch {b['step']} is on {b['data'].device}")
        batches.append((b["step"], b["samples"], b["data"]))
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    to_dev = store.io_stats()["bytes_to_device"]
    nbytes = sum(d.numel() * d.element_size() for _, _, d in batches)
    if len(batches) != n_images // 16:
        fail(f"one epoch gave {len(batches)} batches, want {n_images // 16}")
    lat = loader.stats()["batch_latency"]
    log(f"[stream] epoch to the card: {len(batches)} batches of 16 x 3x1024x1024 "
        f"f32 in {wall!r} s: {len(batches) / wall!r} batches/s, "
        f"{nbytes / wall / 1e9!r} GB/s to the card; consumer wait p50 "
        f"{float(np.percentile(waits, 50)) * 1e3!r} ms p99 "
        f"{float(np.percentile(waits, 99)) * 1e3!r} ms; loader batch latency "
        f"(submit to ready) {json.dumps(lat)}; bytes_to_device {to_dev}; "
        f"launches {json.dumps(counts)}")
    if to_dev != nbytes:
        fail(f"bytes_to_device {to_dev} != batch bytes {nbytes}")

    cuda_hook(False)  # the host loader decodes with the numpy unshuffle
    with StreamLoader(store, "ffhq", **host_kw) as host:
        for (step, samples, data), hb in zip(batches, host):
            if step != hb["step"] or not np.array_equal(samples, hb["samples"]):
                fail(f"step {step}: sample ids differ from the host loader")
            if not same_bytes(data, to_torch(hb["data"], "cuda")):
                fail(f"step {step}: device batch differs from the host loader")
    log(f"[verify] StreamLoader epoch: {len(batches)} CUDA batches "
        f"byte-identical to the host loader's")
    del batches

    t0 = time.perf_counter()
    new = ffhq_like((16, 3, 1024, 1024), seed=1, dtype=np.float32)
    with store.ingest("ffhq", watermark_rows=16) as w:
        w.append_rows(new)
    log(f"[stream] ingest of 16 images: {time.perf_counter() - t0!r} s, "
        f"{w.flushes} watermark commit(s)")
    cuda_hook(True)
    loader = loader.reopen()
    if len(loader.owned) != n_images + 16:
        fail(f"reopen sees {len(loader.owned)} rows, want {n_images + 16}")
    first, seen = None, []
    for b in loader:  # the whole epoch: nothing is left in flight after it
        if not b["data"].is_cuda:
            fail(f"reopened batch {b['step']} is on {b['data'].device}")
        first = first or b
        seen.append(b["samples"])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    loader.close()
    if not np.array_equal(np.sort(np.concatenate(seen)),
                          np.arange(n_images + 16)):
        fail("the reopened loader's epoch does not cover every row once")
    cuda_hook(False)
    with StreamLoader(store, "ffhq", **host_kw) as host:
        hb = next(iter(host))
        if not (np.array_equal(first["samples"], hb["samples"])
                and first["data"].is_cuda
                and same_bytes(first["data"], to_torch(hb["data"], "cuda"))):
            fail("the reopened loader's first batch differs from the host loader")
    log(f"[verify] reopen: an epoch of {len(seen)} CUDA batches covers all "
        f"{n_images + 16} rows once; its first batch is byte-identical to the "
        f"host loader's ({int((first['samples'] >= n_images).sum())} ingested "
        f"rows in it)")
    cuda_hook(True)
    log(f"[stream] launches on the stream path: {json.dumps(counts)}; by "
        f"variant {json.dumps(variant_counts(kernels))}")
    if counts["unshuffle"] <= 0:
        fail("unshuffle was not launched on the stream path")
    return counts


def granite_leaves(layers):
    """Per-pod gradient leaf shapes of granite-3-8b (src/repro/configs/
    granite_3_8b.py: d_model 4096, 32 heads, 8 KV heads, head_dim 128, d_ff
    12800, vocab 49155, untied embeddings), layers stacked on a leading L."""
    d, f, v, q, kv, L = 4096, 12800, 49155, 32 * 128, 8 * 128, layers
    return {"embed": (v, d), "unembed": (d, v), "final_norm/scale": (d,),
            "blocks/ln1/scale": (L, d), "blocks/ln2/scale": (L, d),
            "blocks/attn/wq": (L, d, q), "blocks/attn/wk": (L, d, kv),
            "blocks/attn/wv": (L, d, kv), "blocks/attn/wo": (L, q, d),
            "blocks/mlp/w_gate": (L, d, f), "blocks/mlp/w_up": (L, d, f),
            "blocks/mlp/w_down": (L, f, d)}


def _geometry(shape):
    """(rows, cols), tile, n_tiles, k of one leaf, by the reference's formula
    (src/repro/train/grad_compress.py:40-47, 54)."""
    rows = 1 if len(shape) <= 1 else math.prod(shape[:-1])
    cols = shape[-1] if shape else 1
    bh, bw = min(BLOCK[0], rows), min(BLOCK[1], cols)
    n_tiles = -(-rows // bh) * -(-cols // bw)
    return (rows, cols), (bh, bw), n_tiles, max(1, int(n_tiles * RATIO))


def dyadic_grads(torch, shapes, gen, dev):
    """bf16 integers in [-3, 3] / 8: norms exact in any summation order."""
    return {name: torch.randint(-3, 4, (PODS,) + shape, generator=gen,
                                device=dev, dtype=torch.int8)
            .to(torch.bfloat16).mul_(0.125) for name, shape in shapes.items()}


def row_sparse_grads(torch, shapes, gen, dev):
    """bf16 row-sparse gradients as benchmarks/bench_grad_compress.py:25-27
    makes them: a 0.03 noise floor plus unit Gaussians on 40/512 of rows."""
    out = {}
    for name, shape in shapes.items():
        (rows, cols), _, _, _ = _geometry(shape)
        g = torch.randn((PODS, rows, cols), generator=gen, device=dev).mul_(0.03)
        n_hot = max(1, rows * 40 // 512)
        hot = torch.randperm(rows, generator=gen, device=dev)[:n_hot]
        g[:, hot, :] += torch.randn((PODS, n_hot, cols), generator=gen, device=dev)
        out[name] = g.to(torch.bfloat16).reshape((PODS,) + shape)
        del g
    return out


def compare_on_cpu(torch, gc, grads, resid, mean, new_r, stats, budget_s):
    """Step 1 again on the CPU (the kernels' plain versions), leaf by leaf:
    equal ids, byte-identical blocks, mean and residuals. Past ``budget_s``
    of CPU time it stops after embed, unembed and one stacked block leaf."""
    order = ["embed", "unembed", "final_norm/scale"] + sorted(
        n for n in grads if n.startswith("blocks/"))
    compared = []
    t0 = time.perf_counter()
    for name in order:
        m_c, r_c, s_c = gc.compressed_grad_mean(
            {name: grads[name].cpu()}, {name: resid[name].cpu()}, ratio=RATIO,
            block=BLOCK, with_payload=True)
        ids_c, blocks_c = s_c["payload"][name]
        ids_g, blocks_g = stats["payload"][name]
        for what, c, g in (("ids", ids_c, ids_g), ("blocks", blocks_c, blocks_g),
                           ("mean", m_c[name], mean[name]),
                           ("residual", r_c[name], new_r[name])):
            if not same_bytes(c, g.cpu()):
                fail(f"step 1 {name} {what}: the card differs from the CPU run "
                     f"(max diff {max_abs_err(c, g.cpu())})")
        compared.append(name)
        if time.perf_counter() - t0 > budget_s and len(compared) > 3:
            break
    skipped = [n for n in order if n not in compared]
    log(f"[verify] step 1 equals the CPU run byte for byte (ids, blocks, mean, "
        f"residuals) on {len(compared)} leaves in {time.perf_counter() - t0!r} "
        f"s: {compared}; not compared (CPU time budget): {skipped}")


def check_step(torch, kern, shapes, grads, resid, new_r, stats):
    """decoded + new residual == e exactly, kept norms >= dropped norms, for
    every leaf and pod (plain versions on the card: no launch counted)."""
    for name, shape in shapes.items():
        (rows, cols), bs, n_tiles, _ = _geometry(shape)
        e = (grads[name].to(torch.float32) + resid[name]).view(PODS, rows, cols)
        nr = new_r[name].view(PODS, rows, cols)
        ids, blocks = stats["payload"][name]
        for p in range(PODS):
            dec = kern.block_scatter.plain(torch.zeros_like(e[p]), ids[p], blocks[p])
            if not torch.equal(dec + nr[p], e[p]):
                fail(f"{name} pod {p}: decoded + residual != e")
            norms = kern.block_norms.plain(e[p], bs)
            kept = torch.zeros(n_tiles, dtype=torch.bool, device=e.device)
            kept[ids[p].to(torch.int64)] = True
            if (~kept).any():
                lo, hi = float(norms[kept].min()), float(norms[~kept].max())
                if lo < hi * (1 - NORM_RTOL):
                    fail(f"{name} pod {p}: kept norm {lo} < dropped norm {hi}")
        del e, nr


def compress_path(torch, np, layers):
    """5(b): three compressed steps with error feedback at granite-3-8b
    widths on the card. Returns the launches of the three steps."""
    from repro_torch import kernels as kern
    from repro_torch.train import grad_compress as gc

    dev = torch.device("cuda")
    shapes = granite_leaves(layers)
    n_params = sum(int(np.prod(s)) for s in shapes.values())
    log(f"[compress] granite-3-8b per-pod gradient tree, widths as published, "
        f"depth cut to L = {layers} of 40 layers (device memory: 2 pods of "
        f"bf16 grads + f32 residuals over all 40 layers need ~200 GB): "
        f"{len(shapes)} leaves, {n_params} parameters per pod, {PODS} pods, "
        f"ratio {RATIO}, block {BLOCK}")
    sent = dense = 0
    for shape in shapes.values():
        _, (bh, bw), _, k = _geometry(shape)
        sent += PODS * k * 4 + PODS * k * bh * bw * 4
        dense += PODS * int(np.prod(shape)) * 4
    want_ratio = sent / dense
    gen = torch.Generator(device=dev).manual_seed(0)
    grads = dyadic_grads(torch, shapes, gen, dev)
    resid = gc.init_residuals(grads)
    torch.cuda.synchronize()
    reset_counts(kern)
    grad_bytes = PODS * n_params * 2
    for step in (1, 2, 3):
        if step > 1:
            grads = row_sparse_grads(torch, shapes, gen, dev)
        torch.cuda.synchronize()
        counts_before = kern.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mean, new_r, stats = gc.compressed_grad_mean(
            grads, resid, ratio=RATIO, block=BLOCK, with_payload=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        step_counts = {k: v - counts_before[k]
                       for k, v in kern.launch_counts().items()}
        ratio = gc.compression_ratio_bytes(stats)
        log(f"[compress] step {step} ({'dyadic' if step == 1 else 'row-sparse'}"
            f" grads): {wall * 1e3!r} ms wall, {grad_bytes / wall / 1e9!r} GB/s "
            f"of bf16 gradient bytes, peak device memory {peak} B, wire ratio "
            f"{ratio!r}, launches {json.dumps(step_counts)}")
        if ratio != want_ratio:
            fail(f"wire ratio {ratio!r} != the reference formula's {want_ratio!r}")
        if step == 1:
            compare_on_cpu(torch, gc, grads, resid, mean, new_r, stats, 120.0)
        else:
            check_step(torch, kern, shapes, grads, resid, new_r, stats)
            log(f"[verify] step {step}: decoded + residual == e on every leaf "
                f"and pod; kept norms >= dropped norms")
        for leaf in mean.values():
            if not bool(torch.isfinite(leaf).all()):
                fail(f"step {step}: non-finite mean")
        del mean, stats
        resid = new_r
        if step < 3:
            del grads, new_r
    counts = kern.launch_counts()
    log(f"[compress] launches over the three steps: {json.dumps(counts)}; "
        f"block_gather by variant {json.dumps(kern.block_gather.variant_launches)}")
    for name in COMPRESS_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the compression path")
    busy = profile_call(torch, "compressed step (row-sparse grads)",
                        lambda: gc.compressed_grad_mean(grads, resid,
                                                        ratio=RATIO, block=BLOCK))
    split = {}
    for key, us in busy.items():
        group = next((g for g, marks in STEP_SPLIT
                      if any(mk in key.lower() for mk in marks)),
                     "other (torch elementwise, reductions, fills)")
        split[group] = split.get(group, 0.0) + us / 1e3
    log(f"[profile] compressed step device ms by kernel: {json.dumps(split)}")
    return counts


# -- phase 6: serving ------------------------------------------------------------

SERVE_PROMPT = 32       # tokens of the request held to the CPU's logits
SERVE_REQUESTS, SERVE_SLOTS, SERVE_NEW, SERVE_MAX_LEN = 8, 4, 32, 256
LOGIT_RTOL = 2e-2       # bf16 on the card against bf16 on the CPU
CPU_BUDGET_S = 120.0
SERVE_COMPRESSION = "zlib:1+shuffle"


def serve_config(layers):
    """granite-3-8b at its published widths (src/repro/configs/
    granite_3_8b.py: d_model 4096, 32 heads, 8 KV heads, head_dim 128, d_ff
    12800, vocab 49155, untied, bf16), depth cut to ``layers``."""
    import dataclasses
    from repro_torch.models import get_arch
    return dataclasses.replace(get_arch("granite-3-8b"), n_layers=layers)


def recording_launches(torch, mods):
    """Wrap each module's ``launch`` to record its tensor operands' shapes
    and dtypes (and the other arguments); returns (records, undo). The
    launches and their counts stay the kernels' own."""
    records = {mod.__name__.rsplit(".", 1)[-1]: [] for mod in mods}
    saved = [(mod, mod.launch) for mod in mods]

    def spy(name, fn):
        def launch(*args, **kw):
            records[name].append(tuple(
                (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
                for a in args))
            return fn(*args, **kw)
        return launch

    for mod, fn in saved:
        mod.launch = spy(mod.__name__.rsplit(".", 1)[-1], fn)

    def undo():
        for mod, fn in saved:
            mod.launch = fn
    return records, undo


def check_serve_kernels(torch, kern, records):
    """block_gather and unshuffle against their plain versions, byte for
    byte, at every distinct shape the load gave them (random operands of
    that shape and dtype, a random permutation of ids); returns the
    distinct (shape, dtype, K, tile) of block_gather and (itemsize, n) of
    unshuffle."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    gathers = sorted({(x[0], x[1], ids[0][0], bs)
                      for x, ids, bs in records["block_gather"]})
    for shape, dtype, k, bs in gathers:
        # finite values only (bf16 bit patterns of normal numbers)
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        ids = torch.randperm(shape[0], generator=g, device=dev)[:k].to(torch.int32)
        got = kern.block_gather.launch(x, ids, bs)
        want = kern.block_gather.plain(x, ids, bs)
        if not same_bytes(got, want):
            fail(f"block_gather at the serve shape {shape} {dtype} K={k} {bs}: "
                 f"max diff {max_abs_err(got, want)}")
        del x, got, want
    frames = sorted({planes[0] for (planes,) in records["unshuffle"]})
    for shape in frames:
        planes = torch.randint(0, 256, shape, generator=g, device=dev,
                               dtype=torch.uint8)
        got = kern.unshuffle.launch(planes)
        want = kern.unshuffle.plain(planes)
        if not torch.equal(got, want):
            fail(f"unshuffle at the serve frame {shape}: max diff "
                 f"{max_abs_err(got, want)}")
        del planes, got, want
    torch.cuda.synchronize()
    log(f"[check] serve shapes against the plain versions, max diff 0: "
        f"block_gather {len(gathers)} shapes "
        f"{[(s, str(d), k, b) for s, d, k, b in gathers]}; unshuffle "
        f"{len(frames)} frame shapes (itemsize, n) from {frames[0]} to "
        f"{frames[-1]}")
    return gathers, frames


def time_serve_kernels(torch, kern, gathers, frames):
    """The serve path's largest block_gather and unshuffle, timed beside
    their library calls and bounds; returns {kernel: (ms, library_ms,
    bound_ms, shape)}, each time a (median, min, max) triple."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    out = {}
    shape, dtype, k, bs = max(gathers, key=lambda s: s[0][0] * s[0][1])
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    ids = torch.randperm(shape[0], generator=g, device=dev)[:k].to(torch.int32)
    ids64 = ids.to(torch.int64)
    nbytes = k * bs[1] * x.element_size()
    bound = (2 * nbytes + 4 * k) / HBM_BYTES_PER_S * 1e3
    k_t, lib_t = time_pair_ms(lambda: kern.block_gather.launch(x, ids, bs),
                              lambda: x.index_select(0, ids64), 10)
    out["block_gather"] = (k_t, lib_t, bound, f"K={k} {bs} {dtype}")
    del x
    shape = frames[-1]
    planes = torch.randint(0, 256, shape, generator=g, device=dev,
                           dtype=torch.uint8)
    bound = 2 * planes.numel() / HBM_BYTES_PER_S * 1e3
    k_t, lib_t = time_pair_ms(lambda: kern.unshuffle.launch(planes),
                              lambda: planes.t().contiguous(), 10)
    out["unshuffle"] = (k_t, lib_t, bound, f"planes {shape}")
    del planes
    for name, (ms, lib, bound, what) in out.items():
        log(f"[time] {name} at the serve path's largest shape ({what}): kernel "
            f"{spread(ms)}, library {spread(lib)}, bound {bound!r} ms (bytes)")
    return out


def greedy(torch, tt, params, cfg, prompt, n_new, max_len):
    """prefill + decode_step on one lane, argmax each step: the offline
    reference the engine is held to. Returns (tokens, prefill ms)."""
    dev = torch.device("cuda")
    caches = tt.init_caches(cfg, 1, max_len, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches, _ = tt.prefill(params, cfg, torch.as_tensor(
        prompt[None].astype("int64")).to(dev), caches)
    out = [int(logits[0, -1].argmax())]
    prefill_ms = (time.perf_counter() - t0) * 1e3
    while len(out) < n_new:
        logits, caches, _ = tt.decode_step(
            params, cfg, torch.tensor([[out[-1]]], device=dev), caches)
        out.append(int(logits[0, 0].argmax()))
    return out, prefill_ms


def check_prefill_on_cpu(torch, tt, params, cfg, prompt):
    """One request's prefill logits on the card against the port's own
    forward on the CPU with the same bf16 weights."""
    from repro_torch.tree import tree_map
    dev = torch.device("cuda")
    tok = torch.as_tensor(prompt[None].astype("int64"))
    got, _, _ = tt.prefill(params, cfg, tok.to(dev),
                           tt.init_caches(cfg, 1, SERVE_MAX_LEN, device=dev))
    got = got[0].cpu()
    t0 = time.perf_counter()
    cpu_params = tree_map(lambda t: t.cpu(), params)
    want, _, _ = tt.prefill(cpu_params, cfg, tok,
                            tt.init_caches(cfg, 1, SERVE_MAX_LEN, device="cpu"))
    cpu_s = time.perf_counter() - t0
    want = want[0]
    del cpu_params
    if cpu_s > CPU_BUDGET_S:
        fail(f"the CPU forward took {cpu_s!r} s, over its {CPU_BUDGET_S} s budget")
    if not bool(torch.isfinite(got).all()):
        fail("non-finite prefill logits on the card")
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * diff
    agree = got.argmax(-1)[decided] == want.argmax(-1)[decided]
    log(f"[verify] prefill logits ({SERVE_PROMPT} tokens) against the CPU "
        f"({cpu_s!r} s): max|d| {diff!r}, max|logits_cpu| {scale!r}, ratio "
        f"{diff / scale!r} (limit {LOGIT_RTOL}); argmax agrees on "
        f"{int(agree.sum())} of {int(decided.sum())} positions whose top-1 "
        f"margin exceeds 2 max|d| ({SERVE_PROMPT} positions)")
    if diff > LOGIT_RTOL * scale:
        fail(f"prefill logits differ from the CPU's by {diff!r} > "
             f"{LOGIT_RTOL} * {scale!r}")
    if not bool(agree.all()):
        fail("the prefill argmax differs from the CPU's where the margin decides")


def serve_path(torch, np, layers, workdir):
    """6: granite-3-8b weights saved to the store, cold-loaded onto the card
    through ModelRepo.load (the counted path: block_gather and unshuffle),
    then served through ServeEngine. Returns the load's launches and the
    timings of time_serve_kernels."""
    from repro_torch import kernels as kern
    from repro_torch.core import DeltaTensorStore
    from repro_torch.lake import LocalFSObjectStore
    from repro_torch.models import transformer as tt
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tree import leaves

    dev = torch.device("cuda")
    cfg = serve_config(layers)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tt.init_params(cfg, gen, device=dev)
    n_params = tt.param_count(params)
    tensor_bytes = sum(t.numel() * t.element_size() for _, t in leaves(params))
    log(f"[serve] {cfg.name} at published widths (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, head_dim {cfg.hd}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, untied, {cfg.dtype}); "
        f"depth cut to L = {layers} of 40 layers (the run's time limit: the "
        f"save goes through the host's zlib): {len(leaves(params))} leaves, "
        f"{n_params} parameters, {tensor_bytes} B; weights random from "
        f"torch.Generator seed 0")

    store = DeltaTensorStore(LocalFSObjectStore(str(workdir)), "serve",
                             compression=SERVE_COMPRESSION)
    t0 = time.perf_counter()
    with store.models(cfg.name) as repo:
        repo.save(params)
        stored = repo.stats()["stored_bytes"]
    save_s = time.perf_counter() - t0
    log(f"[serve] save ({SERVE_COMPRESSION}, LocalFSObjectStore): {save_s!r} "
        f"s, {tensor_bytes / save_s / 1e9!r} GB/s of tensor bytes, stored "
        f"{stored} B ({stored / tensor_bytes!r} of the tensor bytes)")

    # the counted path: a cold load onto the card
    template = tt.init_params(cfg, device="meta")
    repo = store.models(cfg.name)
    records, undo = recording_launches(torch, (kern.block_gather, kern.unshuffle))
    torch.cuda.synchronize()
    store.io.stats.reset()
    reset_counts(kern)
    try:
        t0 = time.perf_counter()
        loaded = repo.load(template, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        undo()
    counts = kern.launch_counts()
    variants = variant_counts(kern)
    itemsizes = sorted({planes[0][0] for (planes,) in records["unshuffle"]})
    log(f"[serve] cold load: {load_s!r} s, {tensor_bytes / load_s / 1e9!r} GB/s "
        f"of tensor bytes, {stored / load_s / 1e9!r} GB/s of stored bytes; "
        f"io_stats {json.dumps(store.io_stats(), sort_keys=True, default=str)}")
    log(f"[serve] launches during the load: {json.dumps(counts)}; by variant "
        f"{json.dumps(variants)}; unshuffle itemsizes {itemsizes}")
    for name in ("block_gather", "unshuffle"):
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the serve path")
    if itemsizes != [2] or variants["unshuffle"]["register"] != counts["unshuffle"]:
        fail("the serve path's unshuffle launches were not all the register "
             "variant at itemsize 2")
    for (name, want), (_, got) in zip(leaves(params), leaves(loaded)):
        if not (got.is_cuda and same_bytes(got, want)):
            fail(f"loaded leaf {name} differs from the saved one")
    log(f"[verify] every loaded leaf ({len(leaves(loaded))}) is on the card "
        f"and byte-identical to the saved one")
    del params
    gathers, frames = check_serve_kernels(torch, kern, records)
    times = time_serve_kernels(torch, kern, gathers, frames)
    profile_call(torch, "cold load", lambda: repo.load(template, device="cuda"))
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
    check_prefill_on_cpu(torch, tt, loaded, cfg, prompt)

    # one request alone through the engine against the offline loop
    solo, _ = greedy(torch, tt, loaded, cfg, prompt, SERVE_NEW, SERVE_MAX_LEN)
    with ServeEngine(loaded, cfg, n_slots=1, max_len=SERVE_MAX_LEN) as eng:
        req = Request(rid=0, prompt=prompt, max_new_tokens=SERVE_NEW)
        eng.submit(req)
        eng.run_until_drained()
    if req.out_tokens != solo:
        fail(f"the engine's tokens differ from the offline decode: "
             f"{req.out_tokens} vs {solo}")
    log(f"[verify] one request through ServeEngine (1 slot) equals the offline "
        f"prefill + decode_step loop, {SERVE_NEW} tokens")

    # continuous batching: 8 requests through 4 slots
    lens = rng.integers(16, 129, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    solos, prefill_ms = zip(*[greedy(torch, tt, loaded, cfg, p, SERVE_NEW,
                                     SERVE_MAX_LEN) for p in prompts])
    eng = ServeEngine(loaded, cfg, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    decode_s, decode_tokens, steps = 0.0, 0, 0
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    while any(not r.done for r in reqs):
        queued = eng.queue.qsize()
        t0 = time.perf_counter()
        active = eng.step()
        dt = time.perf_counter() - t0
        steps += 1
        if eng.queue.qsize() == queued and active == SERVE_SLOTS:
            decode_s += dt    # a step that admitted nothing: decode alone
            decode_tokens += active
        if steps > 10_000:
            fail("the batched run did not drain")
    run_s = time.perf_counter() - t_run
    eng.close()
    for r in reqs:
        if not r.done or len(r.out_tokens) != SERVE_NEW:
            fail(f"request {r.rid} ended with {len(r.out_tokens)} tokens")
    agree = [int(sum(a == b for a, b in zip(r.out_tokens, s)))
             for r, s in zip(reqs, solos)]
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] batched run: {SERVE_REQUESTS} requests (prompts "
        f"{lens.tolist()} tokens), {SERVE_SLOTS} slots, {SERVE_NEW} new tokens "
        f"each, max_len {SERVE_MAX_LEN}: {run_s!r} s, {steps} engine steps, "
        f"{SERVE_REQUESTS * SERVE_NEW / run_s!r} tokens/s with prefills; every "
        f"request finished with {SERVE_NEW} tokens")
    log(f"[serve] tokens agreeing with each request's solo run (information, "
        f"not a gate: batch-{SERVE_SLOTS} bf16 matmuls may round otherwise): "
        f"{agree} of {SERVE_NEW}")
    log(f"[serve] prefill ms per request (one lane, prompts {lens.tolist()}): "
        f"{[round(m, 3) for m in prefill_ms]}; decode at {SERVE_SLOTS} slots: "
        f"{decode_tokens} tokens in {decode_s!r} s, {decode_tokens / decode_s!r} "
        f"tokens/s ({decode_s / max(1, decode_tokens) * SERVE_SLOTS * 1e3!r} ms "
        f"a step); peak device memory {peak} B")
    # where the time goes: one prefill (the longest prompt) and one decode
    # step at 4 slots under torch.profiler, after the measured runs
    longest = prompts[int(lens.argmax())]
    profile_call(torch, f"prefill of one {len(longest)}-token request",
                 lambda: greedy(torch, tt, loaded, cfg, longest, 1,
                                SERVE_MAX_LEN))
    with ServeEngine(loaded, cfg, n_slots=SERVE_SLOTS,
                     max_len=SERVE_MAX_LEN) as eng:
        for i, p in enumerate(prompts[:SERVE_SLOTS]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW))
        eng.step()  # admits every slot
        eng.step()
        profile_call(torch, f"decode step at {SERVE_SLOTS} slots", eng.step)
    repo.close()
    return counts, times


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    args = parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels as kern
    from repro_torch.kernels import _build, ops
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(f"[env] nvidia-smi: {nvidia_smi_line()}")

    # 1. build
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"total {time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:
        text = _build.lib_path(name).with_suffix(".log").read_text()
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", text)})
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill", text))
        smem = sorted({int(s) for s in re.findall(r"(\d+) bytes smem", text)})
        log(f"[ptxas] {name}: registers per thread {regs}, static smem bytes "
            f"{smem or [0]}, spill bytes {spills}")

    # 2-3. check and time the kernels at sweep and main-path shapes
    coo_shape = (183, 24, 285, 430)
    from repro_torch.data.synthetic import uber_like
    coo_nnz = uber_like(coo_shape).nnz
    main = main_shapes(torch, np, args.images, int(np.prod(coo_shape)), coo_nnz)
    errs = check_kernels(torch, np, kern, main)
    errs.update(check_compress_kernels(torch, np, kern, main))
    times, dev_ms = time_kernels(torch, kern, main)
    time_unshuffle_hook(torch, np, kern, ops)
    time_launch_path(torch, kern, _build)
    del main
    torch.cuda.empty_cache()

    # 4. the read path, then 5(a) the stream path over the same store
    workroot = ROOT / "build"
    workroot.mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=workroot))
    paths = {}
    try:
        store, paths["read"] = main_path(torch, np, args.images, workdir)
        torch.cuda.empty_cache()
        paths["stream"] = stream_path(torch, np, store, args.images)
        del store
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # 5(b) gradient compression at granite-3-8b widths
    paths["compress"] = compress_path(torch, np, args.layers)
    torch.cuda.empty_cache()

    # 6. serving granite-3-8b from the store
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=workroot))
    try:
        paths["serve"], serve_times = serve_path(torch, np, args.layers, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # 7. report
    rows = []
    for name in REPLACES:
        ms, plain_ms, lib_ms, bound_ms = times[name]
        by_path = {path: counts[name] for path, counts in paths.items()}
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{name}.cu",
               "replaces": REPLACES[name],
               "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": errs[name], "ms": ms[0], "ms_min_max": ms[1:],
               "plain_ms": plain_ms[0], "bound_ms": bound_ms, "bound_by": "bytes",
               "library_ms": lib_ms[0], "library_ms_min_max": lib_ms[1:]}
        if name in dev_ms:
            row["device_ms"], row["library_device_ms"] = dev_ms[name]
        if name in serve_times:
            s_ms, s_lib, s_bound, s_what = serve_times[name]
            row.update(serve_shape=s_what, serve_ms=s_ms[0],
                       serve_library_ms=s_lib[0], serve_bound_ms=s_bound)
        rows.append(row)
    log(nvidia_smi_line())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
