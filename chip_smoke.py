#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py [--images N]

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel of the read path from ``src/repro_torch/kernels/
   csrc`` (one nvcc per source, all at once) and print the build seconds and
   ptxas's register / shared-memory / spill report;
2. check each kernel against its plain PyTorch version on the card, over
   dtype and shape sweeps (ragged shapes included) and at the main path's
   shapes: the max difference must be 0, except for the scatter-add of
   duplicate float indices (atomics add in another order), held to
   ``rtol = atol = 1e-6``;
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
   just before these reads and read just after; each kernel must have run.
   Each result is then checked byte for byte against the host ``read`` /
   ``read_slice`` with the CUDA unshuffle hook taken out;
5. print the card's name and power limit, one JSON line of per-kernel
   numbers, and as the last line ``{"ok": true, "device": {...}}``.

It imports nothing of jax or of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import functools
import json
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


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images", type=int, default=256,
                   help="FFHQ-like images of 3x1024x1024 f32 (default 256)")
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
    return {"gather": (x, ids), "unshuffle": planes,
            "coo_scatter": (idx, vals, coo_size)}


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
    for name, (ms, plain_ms, lib_ms, bound_ms) in out.items():
        log(f"[time] {name}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
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
    log(f"[read] launches during the main path: {json.dumps(counts)}")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

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
    return counts


def profile_read(torch, store, read):
    """Device busy time of one more slice read under torch.profiler (after
    the counted run, so the profiler perturbs no number above)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.lake import set_unshuffle_kernel
    set_unshuffle_kernel(functools.partial(ops.unshuffle_host,
                                           device=store.device))
    name, fn, _ = read
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    set_unshuffle_kernel(None)
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
        return
    log(f"[profile] {name}: wall {wall!r} s (profiled), device busy "
        f"{total_ms!r} ms, idle share {1 - total_ms / 1e3 / wall!r}; top: "
        + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))


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
    times = time_kernels(torch, kern, main)
    time_unshuffle_hook(np, ops)
    del main
    torch.cuda.empty_cache()

    # 4. main path
    workroot = ROOT / "build"
    workroot.mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=workroot))
    try:
        counts = main_path(torch, np, args.images, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # 5. report
    replaces = {"block_gather": "src/repro/kernels/block_gather.py:32",
                "unshuffle": "src/repro/kernels/unshuffle.py:31",
                "coo_scatter": "src/repro/kernels/coo_scatter.py:38"}
    rows = []
    for name in ("block_gather", "unshuffle", "coo_scatter"):
        ms, plain_ms, lib_ms, bound_ms = times[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": replaces[name], "launches": counts[name],
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
