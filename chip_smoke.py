#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py [--images N] [--layers L]

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/
   csrc`` (one nvcc per source, all at once) and print the build seconds and
   ptxas's register / shared-memory / spill report;
2. check each kernel against its plain PyTorch version on the card, over
   dtype and shape sweeps (ragged shapes included) and at the main path's
   shapes: the max difference must be 0, except for the scatter-add of
   duplicate float indices (atomics add in another order), held to
   ``rtol = atol = 1e-6``, and ``block_norms`` of non-dyadic data (positive
   f32 terms summed in another order), held to ``rtol = 1e-5, atol = 0``;
   ``block_norms`` of dyadic data (small integers / 8) must be exact;
3. time each kernel at the main path's shapes with CUDA events, beside its
   bound (bytes moved / 3.35 TB/s), its plain version and one PyTorch call
   computing the same function (``library_ms``; the port never calls it);
4. drive the store's device read path at the paper's width: N FFHQ-like
   images of 3x1024x1024 f32 (N = 256 by default; ``--images`` cuts the
   image count, never the image shape) stored as FTSF with 3-D chunks under
   ``zlib+shuffle``, and the Uber-pickups tensor (183, 24, 285, 430) as f32
   COO, on a local-filesystem object store under ``build/``. Reads:
   ``get_device`` full, ``read_device`` of X[0:100], ``read_many(...,
   device="cuda")``, COO full and COO X[1]. Every launch counter is set to 0
   just before these reads and read just after; each kernel of the read
   path must have run. Each result is then checked byte for byte against
   the host ``read`` / ``read_slice`` with the CUDA unshuffle hook taken out;
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
6. print the card's name and power limit, one JSON line of per-kernel
   numbers, and as the last line ``{"ok": true, "device": {...}}``.

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
                   help="granite-3-8b layers in the gradient tree (default 4 "
                        "of 40; widths are never cut)")
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


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2: kernels against their plain versions ----------------------------

SHAPES_BLOCKS = [((16, 128), (8, 128)), ((32, 256), (8, 128)),
                 ((24, 384), (8, 128)), ((64, 128), (16, 64)),
                 ((9, 130), (4, 64)), ((7, 1000), (1, 1000)),
                 ((5, 333), (1, 333)), ((3, 17), (2, 5))]
FIXED_WIDTH = ["int8", "uint8", "int16", "uint16", "int32", "uint32", "int64",
               "uint64", "float16", "float32", "float64", "complex64",
               "complex128", "bool"]


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


def check_kernels(torch, np, kern, main):
    """Sweeps + main-path shapes; returns {kernel: max_abs_err at main path}."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
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
                got = kern.block_gather.launch(x, ids, bs)
                want = kern.block_gather.plain(x, ids, bs)
                if not same_bytes(got, want):
                    fail(f"block_gather {shape} {bs} {dtype} ids={ids_np}: "
                         f"max diff {max_abs_err(got, want)}")
                n += 1
            # unaligned start: a contiguous view one element into its storage
            xs = _rand(torch, rng, (shape[0] * shape[1] + 1,), dtype,
                       dev)[1:].view(shape)
            ids = torch.from_numpy(rng.choice(nb, size=min(nb, 4),
                                              replace=False).astype(np.int32)).to(dev)
            if not same_bytes(kern.block_gather.launch(xs, ids, bs),
                              kern.block_gather.plain(xs.contiguous(), ids, bs)):
                fail(f"block_gather unaligned {shape} {bs} {dtype}")
            n += 1
    log(f"[check] block_gather sweep: {n} cases, max diff 0")

    n = 0
    for name in FIXED_WIDTH:
        it = np.dtype(name).itemsize
        for cols in (1, 3, 511, 512, 513, 1024, 1300, 4093, 65536 + 7):
            planes = torch.from_numpy(rng.integers(0, 256, (it, cols),
                                                   dtype=np.uint8)).to(dev)
            got = kern.unshuffle.launch(planes)
            if not torch.equal(got, kern.unshuffle.plain(planes)):
                fail(f"unshuffle itemsize {it} n {cols}")
            n += 1
    for it in range(1, kern.unshuffle.MAX_ITEMSIZE + 1):
        planes = torch.from_numpy(rng.integers(0, 256, (it, 2051),
                                               dtype=np.uint8)).to(dev)
        if not torch.equal(kern.unshuffle.launch(planes),
                           kern.unshuffle.plain(planes)):
            fail(f"unshuffle itemsize {it}")
        n += 1
    log(f"[check] unshuffle sweep: {n} cases, max diff 0")

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
    got = kern.block_gather.launch(x, ids, (1, x.shape[1]))
    want = kern.block_gather.plain(x, ids, (1, x.shape[1]))
    errs["block_gather"] = max_abs_err(got, want)
    del got, want
    planes = main["unshuffle"]
    errs["unshuffle"] = max_abs_err(kern.unshuffle.launch(planes),
                                    kern.unshuffle.plain(planes))
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
    """{kernel: (ms, plain_ms, library_ms, bound_ms)} at main-path shapes."""
    out = {}
    x, ids = main["gather"]
    bs = (1, x.shape[1])
    ids64 = ids.to(torch.int64)
    tile_bytes = x.shape[1] * x.element_size()
    bound = (2 * ids.numel() * tile_bytes + ids.numel() * 4) / HBM_BYTES_PER_S * 1e3
    out["block_gather"] = (time_ms(lambda: kern.block_gather.launch(x, ids, bs), 10),
                           time_ms(lambda: kern.block_gather.plain(x, ids, bs), 5),
                           time_ms(lambda: x.index_select(0, ids64), 10), bound)
    planes = main["unshuffle"]
    bound = 2 * planes.numel() / HBM_BYTES_PER_S * 1e3
    out["unshuffle"] = (time_ms(lambda: kern.unshuffle.launch(planes), 50),
                        time_ms(lambda: kern.unshuffle.plain(planes), 20),
                        time_ms(lambda: planes.t().contiguous(), 50), bound)
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
    # with its copy of base (no caller on the main path): every element of
    # out is written once and only base's elements outside the tiles need
    # reading, so at least base read and out written, plus the ids
    copy_bound = (2 * base.numel() * 4 + sel.numel() * 4) / HBM_BYTES_PER_S * 1e3
    copy_ms = time_ms(lambda: kern.block_scatter.launch(base, sel, tiles), 30)
    copy_lib_ms = time_ms(lambda: base.clone().view(gh, BLOCK[0], gw, BLOCK[1])
                          .permute(0, 2, 1, 3).index_put_((ti, tj), tiles), 30)
    log(f"[time] block_scatter with its copy of base: kernel {copy_ms!r} ms, "
        f"clone + index_put_ {copy_lib_ms!r} ms, bound {copy_bound!r} ms (bytes)")
    # the untied unembedding's rows (49155 f32) take single-element loads
    u = torch.randn((4096, 49155), device=e.device)
    u_bound = (u.numel() * 4 + 512 * 385 * 4) / HBM_BYTES_PER_S * 1e3
    log(f"[time] block_norms on unembed (4096, 49155) f32, unvectorised "
        f"loads: {time_ms(lambda: kern.block_norms.launch(u, BLOCK), 20)!r} ms, "
        f"bound {u_bound!r} ms (bytes)")
    del u
    for name, (ms, plain_ms, lib_ms, bound_ms) in out.items():
        mode = " (in place)" if name == "block_scatter" else ""
        log(f"[time] {name}{mode}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
            f"library {lib_ms!r} ms, bound {bound_ms!r} ms (bytes)")
    return out


def time_unshuffle_hook(np, ops):
    """Wall time of the frame-decode hook on one f32 chunk (H2D + kernel +
    D2H), the path decode_frame takes."""
    planes = np.random.default_rng(2).integers(0, 256, (4, 3 * 1024 * 1024),
                                               dtype=np.uint8)
    ops.unshuffle_host(planes, device="cuda")
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        out = ops.unshuffle_host(planes, device="cuda")
    ms = (time.perf_counter() - t0) / reps * 1e3
    if not np.array_equal(out, planes.T):
        fail("unshuffle_host differs from the numpy transpose")
    log(f"[time] unshuffle hook (pinned H2D + kernel + D2H, 12 MiB chunk): "
        f"{ms!r} ms wall")


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
    kernels.reset_launch_counts()
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
    log(f"[read] launches during the read path: {json.dumps(counts)}")
    for name in READ_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the read path")

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
    busy_us = {}
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
    total_ms = sum(busy_us.values()) / 1e3
    top = sorted(busy_us.items(), key=lambda kv: -kv[1])[:6]
    if total_ms == 0:
        log(f"[profile] {name}: the profiler saw no device time (not measured)")
        return busy_us
    log(f"[profile] {name}: wall {wall!r} s (profiled), device busy "
        f"{total_ms!r} ms, idle share {1 - total_ms / 1e3 / wall!r}; top: "
        + "; ".join(f"{k[:100]} {v / 1e3:.3f} ms" for k, v in top))
    return busy_us


# device operations of the compressed step by kernel, from their names
STEP_SPLIT = (("block_norms", ("norms_warp", "norms_block")),
              ("block_gather", ("gather_tiles",)),
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
    kernels.reset_launch_counts()
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
    log(f"[stream] launches on the stream path: {json.dumps(counts)}")
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
    kern.reset_launch_counts()
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
    log(f"[compress] launches over the three steps: {json.dumps(counts)}")
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
    times = time_kernels(torch, kern, main)
    time_unshuffle_hook(np, ops)
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

    # 6. report
    rows = []
    for name in REPLACES:
        ms, plain_ms, lib_ms, bound_ms = times[name]
        by_path = {path: counts[name] for path, counts in paths.items()}
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": REPLACES[name],
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": "bytes",
                     "library_ms": lib_ms})
    log(nvidia_smi_line())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
