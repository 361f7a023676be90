#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py [--images N] [--layers L] [--vlm-layers L]

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
   exact; ``adamw`` (the optimizer's fused step) over ragged and misaligned
   sizes, a g broadcast over 2 pods, bf16, f16 and f32 p, g in p's dtype and
   in f32, decay on and off, and at the main path's (10, 4096, 12800) with
   bf16 p and bf16 or f32 g: m and v within ``rtol = 1e-6`` of the plain
   version's, p within one ulp of its dtype and 99.9 % of it equal;
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
   alternatives); the host time of the launch path's parts; ``block_gather``
   at the compressor's (8, 128) shape is timed in turns with its library
   call and reported in its row; ``adamw`` at the main shape in turns with
   its plain version, beside its bound (22 or 24 B an element) and
   ``torch.optim.AdamW(fused=True)`` over an f32 param of the same size;
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
6b. serving the other families the same way (save, counted cold load with
   its kernels held at every shape it gave them, one prefill against the
   CPU, 1 slot against the offline loop, 8 requests through 4 slots, the
   host's peak RSS during the save, a profiled prefill and decode step),
   except that the prefill is held to the CPU's on the same weights cast to
   f32 on both sides, and its bf16 difference only printed: at random
   weights the deep recurrent stacks carry the two devices' different bf16
   rounding into their logits well past 2e-2, while their f32 forwards
   agree far inside it:
   whisper-tiny at its published depth, xlstm-1.3b at 24 of its 48 layers
   and zamba2-2.7b at 30 of its 54 (``XLSTM_LAYERS``, ``ZAMBA2_LAYERS``),
   and llama-3.2-vision-11b at L = 5 of 40 (``--vlm-layers``), all at
   their published widths (the cuts: the run's time limit). The vlm gets seeded
   ``image_embeds`` (4, 1024, 4096) bf16, whisper seeded ``encoder_frames``
   (4, 1500, 384) bf16 (its 30-s window after the stride-2 conv) and a
   decoder ``max_len`` of 448, its published target length. Then the ssm
   math (the chunked core, its decode step, the conv, sLSTM) is timed at
   its serve shapes;
7. training: granite-3-8b at its published widths, bf16, depth cut to L =
   4 of 40 (``--layers``), random weights from a seeded generator, batches
   of 8x256 tokens read through ``FTSFLoader`` from an FTSF token corpus
   under ``build/``. Step 1 of ``make_train_step`` runs on a 1x16 batch and
   is held to the same call on the CPU (loss and grad norm within 2e-2
   relative, 99 % of the params within one bf16 ulp); steps 2-4 are timed
   (ms, tokens/s, the model-FLOPs share 6 N tokens / step / 989 TFLOP/s)
   and step 5 profiled. The TrainState is checkpointed with
   ``DeltaCheckpointer`` on a local store under ``build/`` (the phase fails
   if the disk lacks 1.5x the state's bytes): ``save_async`` while step 6
   runs, a save that an injected fault breaks (step 5 must stay the only
   step), ``restore(device="cuda")`` (``block_gather``; every leaf, the 0-d
   ones included, byte-identical to the saved state), an incremental save
   of the restored state that uploads no tensor, step 6 again from the
   restore (loss within 1e-3 relative of the uninterrupted run's), a slice
   restore of half of ``params/embed``, and ``prune(keep=1)`` with a
   vacuum. Then three ``make_compressed_train_step`` steps over 2 pods at
   ratio 0.05: pods byte-identical, wire ratio below 0.1. ``block_gather``,
   ``block_norms``, ``block_scatter`` and ``adamw`` must have launched in
   the phase; the first three are held to their plain versions at every
   shape the phase gave them, and ``block_gather`` timed at the restore's
   largest;
7b. training the deep families at published widths, bf16, batches of
   8x256 tokens through ``FTSFLoader``: (a) zamba2-2.7b cut to 2
   super-blocks (14 layers), one forward and backward with remat
   (``nothing_saveable``) and without (``everything_saveable``) on the
   same weights: equal loss, every gradient leaf byte-identical or within
   1e-6 of its max|g|, a lower peak with remat, and from the activations
   saved per super-block the estimated peak of a 54-layer step without
   remat (not run); (b) step 1 of zamba2 cut to one super-block (7 layers),
   f32, held to the same call on the CPU (loss and grad norm within 1e-3
   relative); (c) zamba2-2.7b at its published depth (54 layers) with
   remat, five plain steps (finite loss and grad norm; step ms, tokens/s,
   model-FLOPs share, peak memory, one profiled step); (d) whisper-tiny at
   published depth, seeded ``encoder_frames`` (8, 1500, 384) bf16: three
   plain steps, three ``make_compressed_train_step`` steps over 2 pods at
   ratio 0.05 (pods byte-identical, wire ratio below 0.1; ``block_norms``,
   ``block_gather`` and ``block_scatter`` launch at whisper's leaf shapes
   and are held to their plain versions at each), a ``DeltaCheckpointer``
   save and ``restore(device="cuda")`` (byte-identical, ``block_gather``),
   and ``repro_torch.launch.serve`` over that checkpoint (``--ckpt-gc-keep
   1``, 8 requests, 4 slots), whose tokens must equal an in-process
   ``ServeEngine``'s over the restored params; ``adamw`` must have launched
   in (a)-(c) and in (d);
8. the mesh tooling (``repro_torch.dist``, ``launch.dryrun``,
   ``analysis``), which launches none of the repo's kernels but the plain
   steps' ``adamw`` (a DTensor leaf takes the per-op update): (a) on a real
   1-rank NCCL group, ``jit_train_step`` over a (1, 1) mesh from phase 7's
   granite-3-8b L-layer state (the same seed) and a batch of 8x256 corpus
   tokens, held to ``make_train_step`` from the same state with phase 7's
   step-1 bounds (every placement is Replicate; the byte-identical leaves
   are printed); (c) that plain step counted by ``op_cost``: its FLOPs over
   ``accounting.model_flops`` (core + attention) must lie in [1.0, 2.0]
   (remat and the CE chunks recompute the forward), printed beside the
   counted-FLOPs and 6 N D shares of 989 TFLOP/s; (b) ``python -m
   repro_torch.launch.dryrun`` as rank 0 of whisper-tiny x train_4k on a
   (4, 4) mesh and, on the production (16, 16) mesh, granite-3-8b x
   train_4k and the recurrent train cells, xlstm-1.3b x train_4k cut to 8
   layers (7 mLSTM and 1 sLSTM) and zamba2-2.7b x train_4k cut to 6 (the
   shared attention and 6 Mamba2 layers), each recurrent layer on its
   rank's one row of the batch, and the same two recurrent cells on the
   multi-pod (2, 16, 16) mesh, where each row is shared by 2 ``model``
   ranks that split its heads (the record's ``row_share``), under a fake
   process group, each on the card (its own
   shards, random values: peak memory, a warm step's time, op_cost's
   counts; three processes at once, each timing its step with the card to
   itself) and on meta (counts only, run beside (a), (c) and (e)); the
   card's FLOPs must equal meta's,
   and a train cell's may be at most 1.10 times one device's in the JAX
   reference's step (``REFERENCE_RANK_FLOPS``); each cell prints its
   collective bytes by
   kind and the ten largest by the op that caused them, and its ten
   largest FLOP sites; granite's train cell may move no more collective
   bytes and peak no higher than the 671.0 GB and 26.6 GB it took while
   each op chose its own layout; (d) the same for three
   serving cells on the (16, 16) mesh: granite-3-8b x decode_32k (8 kv
   heads on 16: the cache splits seq, the flash-decode combine),
   mixtral-8x22b x long_500k (``fsdp_tp``, a ring cache of its 4096
   window, MoE at T = 1) and zamba2-2.7b x long_500k (its shared
   attention's 524,288-position caches split on heads, Mamba2 states);
   the largest collective of each step must stay below one layer's k
   shard on the rank; (e) on phase (a)'s NCCL group and (1, 1) mesh, a
   prefill of 8x64 corpus tokens and 8 greedy decode steps of phase 7's
   granite-3-8b state, params and caches placed by the rules, must equal
   the plain prefill and ``decode_step`` byte for byte, logits and caches;
9. print the card's name and power limit, one JSON line of per-kernel
   numbers (launches per path: read, stream, compress, serve, one serve
   path per family of 6b, train, train_zamba2, train_whisper, mesh), and as
   the last line ``{"ok": true, "device": {...}}``.

It imports nothing of jax or of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
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
                   help="granite-3-8b layers in the gradient tree, the served "
                        "and the trained model (default 4 of 40; widths are "
                        "never cut)")
    p.add_argument("--vlm-layers", type=int, default=5,
                   help="llama-3.2-vision-11b layers served in phase 6b, a "
                        "multiple of 5 (default 5 of 40; widths are never "
                        "cut)")
    return p.parse_args()


def log(msg: str) -> None:
    print(msg, flush=True)


# the dry runs this script started (start_dryrun)
CHILDREN = []


def stop_children() -> None:
    """Kill the dry runs still running (after a failure)."""
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    stop_children()
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


# adamw: the kernel against its plain version; p within one ulp of its dtype
# (the moments may round once apart), 99.9 % of p's elements equal
ADAMW_RTOL = 1e-6
ADAMW_EQUAL_SHARE = 0.999
# granite-3-8b's largest stacked leaf at the benchmark's 10 layers
ADAMW_MAIN_SHAPE = (10, 4096, 12800)
# odd sizes take the scalar path; (3, 1000), (64, 300) and (1000, 1028) the
# vector one, with and without a ragged tail of n % 256
ADAMW_SHAPES = [(), (1,), (7,), (9,), (4099,), (3, 1000), (5, 13, 7),
                (64, 300), (1000, 1028), (2, 257, 1031)]
_INT_VIEW = {"float32": "int32", "float16": "int16", "bfloat16": "int16"}


def _adamw_operands(torch, shape, p_dtype, g_dtype, gen, dev, *, skew=0,
                    pods=0):
    """(g, p, m, v) of ``shape``; ``skew`` elements in from an aligned base
    (a contiguous view that starts off 16 bytes), g broadcast over ``pods``
    leading copies when ``pods`` > 0."""
    def make(shape, dtype, scale, positive=False):
        n = math.prod(shape) + skew
        x = (torch.rand if positive else torch.randn)(
            n, generator=gen, device=dev)
        return (x * scale).to(dtype)[skew:].view(shape)
    full = ((pods,) if pods else ()) + tuple(shape)
    g = make(shape, g_dtype, 0.3)
    if pods:
        g = g[None].expand(full)
    return (g, make(full, p_dtype, 1.0), make(full, torch.float32, 0.1),
            make(full, torch.float32, 0.01, positive=True))


def _adamw_scalars(torch, opt, ocfg, count, dev):
    count = torch.tensor(count, dtype=torch.int32, device=dev)
    c = count.to(torch.float32)
    return (torch.tensor(0.7, device=dev), opt.schedule(ocfg, count),
            1 - torch.pow(ocfg.b1, c), 1 - torch.pow(ocfg.b2, c))


def _adamw_compare(torch, got, want, what):
    """Fail unless m and v agree within ADAMW_RTOL and p within one ulp
    with ADAMW_EQUAL_SHARE of it equal; returns (moments' worst relative
    difference, p's largest ulp distance, p's share equal)."""
    (p, m, v), (wp, wm, wv) = got, want
    worst = 0.0
    for a, b, name in ((m, wm, "m"), (v, wv, "v")):
        if not torch.allclose(a, b, rtol=ADAMW_RTOL, atol=0):
            fail(f"adamw {what}: {name} beyond rtol {ADAMW_RTOL}: max diff "
                 f"{max_abs_err(a, b)}")
        worst = max(worst, float(((a - b).abs() / b.abs().clamp_min(1e-30))
                                 .max()) if a.numel() else 0.0)
    if p.numel() == 0:
        return worst, 0, 1.0
    ints = getattr(torch, _INT_VIEW[str(p.dtype).split(".")[-1]])
    ulps = (p.contiguous().view(ints).to(torch.int64)
            - wp.contiguous().view(ints).to(torch.int64)).abs()
    far, equal = int(ulps.max()), float((ulps == 0).double().mean())
    if far > 1 or equal < ADAMW_EQUAL_SHARE:
        fail(f"adamw {what}: p {far} ulps apart at most, {equal!r} equal "
             f"(limits 1 ulp, {ADAMW_EQUAL_SHARE})")
    return worst, far, equal


def _adamw_pair(torch, kern, ops_kw, g, p, m, v, scalars, what):
    """The kernel and the plain version on copies of the same leaf."""
    want = [p.clone(), m.clone(), v.clone()]
    kern.adamw.plain(g, *want, *scalars, **ops_kw)
    kern.adamw.launch(g, p, m, v, *scalars, **ops_kw)
    return _adamw_compare(torch, (p, m, v), want, what)


def check_adamw(torch, np, kern):
    """The fused AdamW kernel against its plain version on the card: ragged
    and misaligned sizes, a broadcast g, bf16, f16 and f32 p, g in p's
    dtype and in f32, decay on (ndim >= 2) and off; then the main-path
    shape with bf16 p and bf16 (plain step) and f32 (compressed step) g.
    Returns the main shape's (kernel, plain, library, bound) timings and
    numbers for the report."""
    from repro_torch.train import optimizer as opt
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    ocfg = opt.OptConfig(**TRAIN_OPT)
    kw = dict(b1=ocfg.b1, b2=ocfg.b2, eps=ocfg.eps,
              weight_decay=ocfg.weight_decay)
    scalars = _adamw_scalars(torch, opt, ocfg, 3, dev)
    t0 = time.perf_counter()
    n, worst, far, equal = 0, 0.0, 0, 1.0
    for shape in ADAMW_SHAPES:
        for p_dtype in (torch.bfloat16, torch.float16, torch.float32):
            for g_dtype in dict.fromkeys((p_dtype, torch.float32)):
                for skew, pods in ((0, 0), (1, 0), (0, 2), (1, 2)):
                    what = (f"{shape} p {p_dtype} g {g_dtype} skew {skew} "
                            f"pods {pods}")
                    ops = _adamw_operands(torch, shape, p_dtype, g_dtype, gen,
                                          dev, skew=skew, pods=pods)
                    w, f, e = _adamw_pair(torch, kern, kw, *ops, scalars, what)
                    worst, far, equal = max(worst, w), max(far, f), min(equal, e)
                    n += 1
    torch.cuda.synchronize()
    log(f"[check] adamw sweep: {n} cases, moments' worst relative diff "
        f"{worst!r} (limit {ADAMW_RTOL}), p at most {far} ulp apart, at "
        f"least {equal!r} of p equal, {time.perf_counter() - t0!r} s")

    launches = kern.adamw.launches
    numel = math.prod(ADAMW_MAIN_SHAPE)
    row = {"shape": list(ADAMW_MAIN_SHAPE)}
    for g_dtype in (torch.bfloat16, torch.float32):
        g, p, m, v = _adamw_operands(torch, ADAMW_MAIN_SHAPE, torch.bfloat16,
                                     g_dtype, gen, dev)
        tag = "g_" + str(g_dtype).split(".")[-1]
        w, f, e = _adamw_pair(torch, kern, kw, g, p, m, v, scalars,
                              f"main shape {tag}")
        nbytes = numel * (g.element_size() + 2 * 2 + 4 * 4)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        k_t, plain_t = time_pair_ms(
            lambda: kern.adamw.launch(g, p, m, v, *scalars, **kw),
            lambda: kern.adamw.plain(g, p, m, v, *scalars, **kw), 3)
        dev_ms = device_ms_per_call(
            torch, lambda: kern.adamw.launch(g, p, m, v, *scalars, **kw), 5)[0]
        row[tag] = {"max_rel_moments": w, "p_ulps": f, "p_equal": e,
                    "ms": k_t[0], "ms_min_max": k_t[1:], "device_ms": dev_ms,
                    "plain_ms": plain_t[0], "bytes": nbytes, "bound_ms": bound,
                    "roofline": 100.0 * bound / k_t[0]}
        log(f"[check] adamw at the main shape {ADAMW_MAIN_SHAPE}, bf16 p, "
            f"{tag}: moments' worst relative diff {w!r}, p at most {f} ulp "
            f"apart, {e!r} equal")
        log(f"[time] adamw {tag}: kernel {spread(k_t)} (device "
            f"{dev_ms!r}), plain {spread(plain_t)}, bound {bound!r} ms "
            f"({nbytes} B at 3.35 TB/s): {100.0 * bound / k_t[0]!r} % of it")
        del g, p, m, v
        torch.cuda.empty_cache()
    # the yardstick: torch's fused AdamW over an f32 param of the same
    # size (f32 p, g and moments: 28 B an element); the port never calls it
    w = torch.nn.Parameter(torch.randn(ADAMW_MAIN_SHAPE, generator=gen,
                                       device=dev))
    w.grad = torch.randn(ADAMW_MAIN_SHAPE, generator=gen, device=dev)
    fused = torch.optim.AdamW([w], lr=ocfg.lr, betas=(ocfg.b1, ocfg.b2),
                              eps=ocfg.eps, weight_decay=ocfg.weight_decay,
                              fused=True)
    lib_t = time_ms(fused.step, 3)
    row["library_ms"], row["library_bytes"] = lib_t[0], numel * 28
    log(f"[time] adamw's yardstick torch.optim.AdamW(fused=True), f32 param "
        f"of the same shape ({numel * 28} B): {spread(lib_t)}")
    del w, fused
    torch.cuda.empty_cache()
    if kern.adamw.launches <= launches:
        fail("adamw did not launch at the main-path shape")
    log(f"[check] adamw: {time.perf_counter() - t0!r} s in all")
    return row


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
    g_ms, g_lib = time_pair_ms(lambda: kern.block_gather.launch(e, sel, BLOCK),
                               lambda: egrid[ti, tj], 30)
    g_dev = device_ms_per_call(
        torch, lambda: kern.block_gather.launch(e, sel, BLOCK), 30)[0]
    log(f"[time] block_gather at the compress shape, K = {sel.numel()} "
        f"{BLOCK} f32 tiles of ({m}, {n}), in turns with its library call, "
        f"launches by variant "
        f"{json.dumps(kern.block_gather.variant_launches)}: kernel "
        f"{spread(g_ms)} (device {g_dev!r} ms), library (permuted view "
        f"[ti, tj]) {spread(g_lib)}, bound {g_bound!r} ms (bytes)")
    compress_times = {
        "compress_shape": f"K={sel.numel()} {BLOCK} torch.float32 of "
                          f"({m}, {n})",
        "compress_ms": g_ms[0], "compress_device_ms": g_dev,
        "compress_library_ms": g_lib[0], "compress_bound_ms": g_bound}
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
    return (out, {name: (k[0], lib[0]) for name, (k, lib) in dev_ms.items()},
            compress_times)


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
    and dtypes, the other arguments, then its keyword arguments as (name,
    value) pairs; returns (records, undo). The launches and their counts
    stay the kernels' own."""
    records = {mod.__name__.rsplit(".", 1)[-1]: [] for mod in mods}
    saved = [(mod, mod.launch) for mod in mods]

    def spy(name, fn):
        def launch(*args, **kw):
            records[name].append(tuple(
                (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
                for a in args) + tuple(sorted(kw.items())))
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
    shape = max(frames, key=lambda s: s[0] * s[1])
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


def greedy(torch, tt, params, cfg, prompt, n_new, max_len, extra=None,
           enc_len=1):
    """prefill + decode_step on one lane, argmax each step: the offline
    reference the engine is held to (``extra``: row 0 of each stub-frontend
    input, given to every call, as a 1-slot engine gives it). Returns
    (tokens, prefill ms)."""
    dev = torch.device("cuda")
    extra = extra or {}
    caches = tt.init_caches(cfg, 1, max_len, enc_len=enc_len, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches, _ = tt.prefill(params, cfg, torch.as_tensor(
        prompt[None].astype("int64")).to(dev), caches, **extra)
    out = [int(logits[0, -1].argmax())]
    prefill_ms = (time.perf_counter() - t0) * 1e3
    while len(out) < n_new:
        logits, caches, _ = tt.decode_step(
            params, cfg, torch.tensor([[out[-1]]], device=dev), caches,
            **extra)
        out.append(int(logits[0, 0].argmax()))
    return out, prefill_ms


def _prefill_logits(torch, tt, params, cfg, tok, extra, enc_len, max_len,
                    device):
    """(T, V) f32 prefill logits of one lane on ``device``."""
    caches = tt.init_caches(cfg, 1, max_len, enc_len=enc_len, device=device)
    logits, _, _ = tt.prefill(params, cfg, tok.to(device), caches,
                              **{k: v.to(device) for k, v in extra.items()})
    return logits[0]


def _compare_logits(torch, got, want):
    """(max|d|, max|want|, argmax agreements, decided positions): argmax is
    decided where want's top-1 margin exceeds 2 max|d|."""
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * diff
    agree = got.argmax(-1)[decided] == want.argmax(-1)[decided]
    return diff, scale, int(agree.sum()), int(decided.sum())


def check_prefill_on_cpu(torch, tt, params, cfg, prompt, tag="serve",
                         extra=None, enc_len=1, max_len=SERVE_MAX_LEN,
                         in_f32=False):
    """One request's prefill logits on the card against the port's own
    forward on the CPU with the same weights and stub-frontend rows: in the
    served dtype, or, with ``in_f32``, on the same weights cast to f32 on
    both sides (the served-dtype difference is then printed beside it)."""
    import dataclasses
    from repro_torch.tree import tree_map
    extra = extra or {}
    tok = torch.as_tensor(prompt[None].astype("int64"))
    runs = [("served dtype", params, cfg, extra)]
    if in_f32:
        runs.append(("f32", tree_map(lambda t: t.float(), params),
                     dataclasses.replace(cfg, dtype="float32"),
                     {k: v.float() for k, v in extra.items()}))
    cpu_s = 0.0
    for what, p, c, x in runs:
        got = _prefill_logits(torch, tt, p, c, tok, x, enc_len, max_len,
                              "cuda").cpu()
        if not bool(torch.isfinite(got).all()):
            fail(f"[{tag}] non-finite prefill logits on the card ({what})")
        t0 = time.perf_counter()
        cpu_params = tree_map(lambda t: t.cpu(), p)
        want = _prefill_logits(torch, tt, cpu_params, c, tok, x, enc_len,
                               max_len, "cpu")
        cpu_s += time.perf_counter() - t0
        del cpu_params, p
        diff, scale, agree, decided = _compare_logits(torch, got, want)
        gated = what == runs[-1][0]
        log(f"[verify] {tag} prefill logits ({len(prompt)} tokens, {what}) "
            f"against the CPU: max|d| {diff!r}, max|logits_cpu| {scale!r}, "
            f"ratio {diff / scale!r} "
            f"({f'limit {LOGIT_RTOL}' if gated else 'information'}); argmax "
            f"agrees on {agree} of {decided} positions whose top-1 margin "
            f"exceeds 2 max|d| ({len(prompt)} positions)")
        if not gated:
            continue
        if cpu_s > CPU_BUDGET_S:
            fail(f"[{tag}] the CPU forward took {cpu_s!r} s, over its "
                 f"{CPU_BUDGET_S} s budget")
        if diff > LOGIT_RTOL * scale:
            fail(f"[{tag}] prefill logits ({what}) differ from the CPU's by "
                 f"{diff!r} > {LOGIT_RTOL} * {scale!r}")
        if agree != decided:
            fail(f"[{tag}] the prefill argmax ({what}) differs from the CPU's "
                 f"where the margin decides")
    runs.clear()
    log(f"[verify] {tag}: the CPU forwards took {cpu_s!r} s")


class PeakRSS:
    """The host's peak resident set over a ``with`` block, sampled every
    10 ms from /proc/self/statm by a thread (``peak``, ``base`` in B)."""

    def __init__(self):
        import os
        import threading
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.base = self.peak = self._rss()

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _run(self) -> None:
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._rss())

    def __enter__(self) -> "PeakRSS":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def serve_path(torch, np, layers, workdir):
    """6: granite-3-8b weights saved to the store, cold-loaded onto the card
    through ModelRepo.load (the counted path: block_gather and unshuffle),
    then served through ServeEngine. Returns the load's launches and the
    timings of time_serve_kernels."""
    cfg = serve_config(layers)
    return serve_model(torch, np, cfg, workdir, tag="serve", depth=(
        f"depth cut to L = {layers} of 40 layers (the run's time limit: the "
        f"save goes through the host's zlib)"), profile_load=True)


def serve_model(torch, np, cfg, workdir, *, tag, depth, extra_rows=None,
                enc_len=1, max_len=SERVE_MAX_LEN, profile_load=False,
                check_in_f32=False):
    """Save ``cfg``'s seeded random weights to the store, cold-load them
    onto the card through ModelRepo.load (the counted path: block_gather
    and unshuffle), hold the load and one prefill to their references, then
    serve through ServeEngine (1 slot against the offline loop, then 8
    requests through 4 slots). ``extra_rows`` makes the stub frontends'
    inputs, one row per slot, from a generator; ``check_in_f32`` holds the
    prefill to the CPU's in f32 (see check_prefill_on_cpu). Returns the
    load's launches and the timings of time_serve_kernels."""
    from repro_torch import kernels as kern
    from repro_torch.core import DeltaTensorStore
    from repro_torch.lake import LocalFSObjectStore
    from repro_torch.models import transformer as tt
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tree import leaves

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tt.init_params(cfg, gen, device=dev)
    n_params = tt.param_count(params)
    tensor_bytes = sum(t.numel() * t.element_size() for _, t in leaves(params))
    log(f"[{tag}] {cfg.name} ({cfg.family}) at published widths (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, "
        f"head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{'tied' if cfg.tie_embeddings else 'untied'}, {cfg.dtype}); "
        f"{depth}: {len(leaves(params))} leaves, {n_params} parameters, "
        f"{tensor_bytes} B; weights random from torch.Generator seed 0")

    store = DeltaTensorStore(LocalFSObjectStore(str(workdir)), "serve",
                             compression=SERVE_COMPRESSION)
    with PeakRSS() as rss:
        t0 = time.perf_counter()
        with store.models(cfg.name) as repo:
            repo.save(params)
            stored = repo.stats()["stored_bytes"]
        save_s = time.perf_counter() - t0
    log(f"[{tag}] save ({SERVE_COMPRESSION}, LocalFSObjectStore): {save_s!r} "
        f"s, {tensor_bytes / save_s / 1e9!r} GB/s of tensor bytes, stored "
        f"{stored} B ({stored / tensor_bytes!r} of the tensor bytes); host "
        f"peak RSS during the save {rss.peak} B ({rss.peak - rss.base} B "
        f"above the {rss.base} B before it)")

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
    leaf_sizes = sorted({t.element_size() for _, t in leaves(params)})
    log(f"[{tag}] cold load: {load_s!r} s, {tensor_bytes / load_s / 1e9!r} "
        f"GB/s of tensor bytes, {stored / load_s / 1e9!r} GB/s of stored "
        f"bytes; io_stats "
        f"{json.dumps(store.io_stats(), sort_keys=True, default=str)}")
    log(f"[{tag}] launches during the load: {json.dumps(counts)}; by variant "
        f"{json.dumps(variants)}; unshuffle itemsizes {itemsizes} (leaf "
        f"itemsizes {leaf_sizes})")
    for name in ("block_gather", "unshuffle"):
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the {tag} path")
    if (not set(itemsizes) <= set(leaf_sizes)
            or variants["unshuffle"]["register"] != counts["unshuffle"]):
        fail(f"the {tag} path's unshuffle launches were not all the register "
             f"variant at the leaves' itemsizes")
    for (name, want), (_, got) in zip(leaves(params), leaves(loaded)):
        if not (got.is_cuda and same_bytes(got, want)):
            fail(f"[{tag}] loaded leaf {name} differs from the saved one")
    log(f"[verify] {tag}: every loaded leaf ({len(leaves(loaded))}) is on the "
        f"card and byte-identical to the saved one")
    del params
    gathers, frames = check_serve_kernels(torch, kern, records)
    times = time_serve_kernels(torch, kern, gathers, frames)
    if profile_load:
        profile_call(torch, "cold load",
                     lambda: repo.load(template, device="cuda"))
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    extra = {}
    if extra_rows is not None:
        extra = extra_rows(torch.Generator(device=dev).manual_seed(1))
        log(f"[{tag}] stub frontend inputs, one row per slot: "
            + ", ".join(f"{k} {tuple(v.shape)} {v.dtype}"
                        for k, v in extra.items()))
    row0 = {k: v[:1] for k, v in extra.items()}
    prompt = rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
    check_prefill_on_cpu(torch, tt, loaded, cfg, prompt, tag, row0, enc_len,
                         max_len, in_f32=check_in_f32)

    def engine(n_slots):
        return ServeEngine(loaded, cfg, n_slots=n_slots, max_len=max_len,
                           extra_inputs=extra, enc_len=enc_len)

    # one request alone through the engine against the offline loop
    solo, _ = greedy(torch, tt, loaded, cfg, prompt, SERVE_NEW, max_len, row0,
                     enc_len)
    with engine(1) as eng:
        req = Request(rid=0, prompt=prompt, max_new_tokens=SERVE_NEW)
        eng.submit(req)
        eng.run_until_drained()
    if req.out_tokens != solo:
        fail(f"[{tag}] the engine's tokens differ from the offline decode: "
             f"{req.out_tokens} vs {solo}")
    log(f"[verify] {tag}: one request through ServeEngine (1 slot) equals the "
        f"offline prefill + decode_step loop, {SERVE_NEW} tokens")

    # continuous batching: 8 requests through 4 slots
    lens = rng.integers(16, 129, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    solos, prefill_ms = zip(*[greedy(torch, tt, loaded, cfg, p, SERVE_NEW,
                                     max_len, row0, enc_len)
                              for p in prompts])
    eng = engine(SERVE_SLOTS)
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
            fail(f"[{tag}] the batched run did not drain")
    run_s = time.perf_counter() - t_run
    eng.close()
    for r in reqs:
        if not r.done or len(r.out_tokens) != SERVE_NEW:
            fail(f"[{tag}] request {r.rid} ended with {len(r.out_tokens)} "
                 f"tokens")
    agree = [int(sum(a == b for a, b in zip(r.out_tokens, s)))
             for r, s in zip(reqs, solos)]
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] batched run: {SERVE_REQUESTS} requests (prompts "
        f"{lens.tolist()} tokens), {SERVE_SLOTS} slots, {SERVE_NEW} new tokens "
        f"each, max_len {max_len}: {run_s!r} s, {steps} engine steps, "
        f"{SERVE_REQUESTS * SERVE_NEW / run_s!r} tokens/s with prefills; every "
        f"request finished with {SERVE_NEW} tokens")
    log(f"[{tag}] tokens agreeing with each request's solo run (information, "
        f"not a gate: batch-{SERVE_SLOTS} bf16 matmuls may round otherwise, "
        f"and a request decodes with its slot's frontend row): {agree} of "
        f"{SERVE_NEW}")
    log(f"[{tag}] prefill ms per request (one lane, prompts {lens.tolist()}): "
        f"{[round(m, 3) for m in prefill_ms]}; decode at {SERVE_SLOTS} slots: "
        f"{decode_tokens} tokens in {decode_s!r} s, {decode_tokens / decode_s!r} "
        f"tokens/s ({decode_s / max(1, decode_tokens) * SERVE_SLOTS * 1e3!r} ms "
        f"a step); peak device memory {peak} B")
    # where the time goes: one prefill (the longest prompt) and one decode
    # step at 4 slots under torch.profiler, after the measured runs
    longest = prompts[int(lens.argmax())]
    profile_call(torch, f"{tag} prefill of one {len(longest)}-token request",
                 lambda: greedy(torch, tt, loaded, cfg, longest, 1, max_len,
                                row0, enc_len))
    with engine(SERVE_SLOTS) as eng:
        for i, p in enumerate(prompts[:SERVE_SLOTS]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW))
        eng.step()  # admits every slot
        eng.step()
        profile_call(torch, f"{tag} decode step at {SERVE_SLOTS} slots",
                     eng.step)
    repo.close()
    return counts, times


# -- phase 6b: serving the other families ------------------------------------------

WHISPER_FRAMES = 1500    # whisper's 30-s window after its stride-2 conv
WHISPER_MAX_LEN = 448    # whisper's published target length
# 6b's recurrent families, cut to about half their published depth (48 and
# 54) to keep the run inside its time limit
XLSTM_LAYERS, ZAMBA2_LAYERS = 24, 30


def frontend_rows(key, n, d, dtype):
    """A maker of SERVE_SLOTS seeded rows of an (n, d) stub-frontend input
    (``key``) from a generator on the card."""
    def make(gen):
        import torch
        return {key: torch.randn((SERVE_SLOTS, n, d), generator=gen,
                                 device=gen.device).to(dtype)}
    return make


def family_configs(vlm_layers):
    """{arch: (config, depth note, stub-frontend rows or None, enc_len,
    max_len)} of phase 6b, at published widths (src/repro/configs/)."""
    import dataclasses
    from repro_torch.models import get_arch
    from repro_torch.models.layers import dtype_of
    vlm = get_arch("llama-3.2-vision-11b")
    whisper = get_arch("whisper-tiny")
    return {
        "whisper-tiny": (
            whisper, "published depth (4 encoder + 4 decoder layers)",
            frontend_rows("encoder_frames", WHISPER_FRAMES, whisper.d_model,
                          dtype_of(whisper.dtype)),
            WHISPER_FRAMES, WHISPER_MAX_LEN),
        "xlstm-1.3b": (
            dataclasses.replace(get_arch("xlstm-1.3b"), n_layers=XLSTM_LAYERS),
            f"depth cut to {XLSTM_LAYERS} of 48 layers ("
            f"{XLSTM_LAYERS // 8} super-blocks of 7 mLSTM + 1 sLSTM; the "
            f"run's time limit)", None, 1, SERVE_MAX_LEN),
        "zamba2-2.7b": (
            dataclasses.replace(get_arch("zamba2-2.7b"),
                                n_layers=ZAMBA2_LAYERS),
            f"depth cut to {ZAMBA2_LAYERS} of 54 Mamba2 layers (the shared "
            f"attention block before every 6; the run's time limit)", None,
            1, SERVE_MAX_LEN),
        "llama-3.2-vision-11b": (
            dataclasses.replace(vlm, n_layers=vlm_layers),
            f"depth cut to L = {vlm_layers} of 40 "
            f"({vlm_layers // vlm.cross_attn_every} super-blocks of 1 cross "
            f"+ 4 self; the "
            f"run's time limit: 20.2 GB whole would add ~280 s of save and "
            f"load and a CPU forward over 20 GB)",
            frontend_rows("image_embeds", vlm.n_image_tokens, vlm.d_model,
                          dtype_of(vlm.dtype)), 1, SERVE_MAX_LEN),
    }


def time_recurrent_parts(torch):
    """The ssm math that phase 6b runs in plain PyTorch (no kernel of this
    repo), timed at its serve shapes: wall ms a call (CUDA events over
    back-to-back calls) and device ms a call (torch.profiler); their gap
    is the host's launch path."""
    from repro_torch.models import get_arch, ssm
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16

    def rand(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def decay(*shape):
        return torch.rand(shape, generator=g, device=dev) * 0.5 + 0.5
    zamba, xlstm = get_arch("zamba2-2.7b"), get_arch("xlstm-1.3b")
    _, heads, n, conv_ch = ssm.mamba2_dims(zamba)
    p = zamba.ssm_head_dim
    _, mh, mn, mp = ssm.mlstm_dims(xlstm)
    conv = {"w": rand(ssm.CONV_K, conv_ch)}
    slstm = ssm.slstm_init(g, xlstm, bf, dev)
    t = SERVE_MAX_LEN // 2       # the longest prompt: one 128-token chunk
    cases = {
        f"gla_chunked, Mamba2 prefill (1, {t}, {heads}, {n}|{p})":
            (lambda q, k, v, a: ssm.gla_chunked(q, k, v, a, t),
             (rand(1, t, heads, n), rand(1, t, heads, n), rand(1, t, heads, p),
              decay(1, t, heads))),
        f"gla_chunked, mLSTM prefill (1, {t}, {mh}, {mn}|{mp + 1})":
            (lambda q, k, v, a: ssm.gla_chunked(q, k, v, a, t),
             (rand(1, t, mh, mn), rand(1, t, mh, mn), rand(1, t, mh, mp + 1),
              decay(1, t, mh))),
        f"gla_step, Mamba2 decode ({SERVE_SLOTS}, 1, {heads}, {n}|{p})":
            (lambda q, k, v, a, s: ssm.gla_step(q, k, v, a, ssm.GLAState(s)),
             (rand(SERVE_SLOTS, 1, heads, n), rand(SERVE_SLOTS, 1, heads, n),
              rand(SERVE_SLOTS, 1, heads, p), decay(SERVE_SLOTS, 1, heads),
              rand(SERVE_SLOTS, heads, n, p, dtype=torch.float32))),
        f"gla_step, mLSTM decode ({SERVE_SLOTS}, 1, {mh}, {mn}|{mp + 1})":
            (lambda q, k, v, a, s: ssm.gla_step(q, k, v, a, ssm.GLAState(s)),
             (rand(SERVE_SLOTS, 1, mh, mn), rand(SERVE_SLOTS, 1, mh, mn),
              rand(SERVE_SLOTS, 1, mh, mp + 1), decay(SERVE_SLOTS, 1, mh),
              rand(SERVE_SLOTS, mh, mn, mp + 1, dtype=torch.float32))),
        f"conv_apply, Mamba2 prefill (1, {t}, {conv_ch})":
            (lambda x: ssm.conv_apply(conv, x), (rand(1, t, conv_ch),)),
        f"conv_step, Mamba2 decode ({SERVE_SLOTS}, 1, {conv_ch})":
            (lambda x, st: ssm.conv_step(conv, x, st),
             (rand(SERVE_SLOTS, 1, conv_ch),
              rand(SERVE_SLOTS, ssm.CONV_K - 1, conv_ch))),
        f"slstm_apply, prefill of {t} tokens (1 lane, d_model "
        f"{xlstm.d_model})":
            (lambda x: ssm.slstm_apply(slstm, x, xlstm),
             (rand(1, t, xlstm.d_model),)),
        f"slstm_apply, decode ({SERVE_SLOTS} slots)":
            (lambda x, c: ssm.slstm_apply(slstm, x, xlstm, cache=c),
             (rand(SERVE_SLOTS, 1, xlstm.d_model),
              ssm.slstm_cache_init(xlstm, SERVE_SLOTS, dev))),
    }
    for name, (fn, args) in cases.items():
        wall = time_ms(lambda: fn(*args), 5)
        dev_ms, rows = device_ms_per_call(torch, lambda: fn(*args), 5)
        n_ops = sum(int(re.search(r" x(\d+): \S+ ms$", r).group(1))
                    for r in rows) // 5
        log(f"[time] {name}: {spread(wall)} a call, device {dev_ms!r} ms in "
            f"{n_ops} device operations a call (plain PyTorch, no kernel)")


def families_path(torch, np, vlm_layers, workroot):
    """6b: each other family served from the store as phase 6 serves
    granite. Returns {arch: (the load's launches, serve kernel timings)}."""
    out = {}
    for name, (cfg, depth, rows, enc_len, max_len) in family_configs(
            vlm_layers).items():
        workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_",
                                        dir=workroot))
        t0 = time.perf_counter()
        try:
            out[name] = serve_model(torch, np, cfg, workdir, tag=f"serve {name}",
                                    depth=depth, extra_rows=rows,
                                    enc_len=enc_len, max_len=max_len,
                                    check_in_f32=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
        log(f"[serve {name}] phase 6b for {name}: "
            f"{time.perf_counter() - t0!r} s")
    time_recurrent_parts(torch)
    return out


# -- phase 7: training -----------------------------------------------------------

TRAIN_B, TRAIN_T = 8, 256        # 2048 tokens a step; the pods split the batch
TRAIN_SAMPLES = 128              # token rows in the corpus (16 batches)
SHORT_B, SHORT_T = 1, 16         # step 1's batch, run again on the CPU
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
STEP_RTOL = 2e-2                 # loss and grad norm, bf16 card against bf16 CPU
ULP_SHARE = 0.99                 # share of params within one bf16 ulp of the CPU's
RESUME_RTOL = 1e-3               # resumed step's loss against the uninterrupted one
TRAIN_CPU_BUDGET_S = 300.0
WIRE_LIMIT = 0.1
PEAK_BF16_FLOPS = 989e12         # H100 SXM, dense bf16 (NVIDIA data sheet)


def bf16_ulp(torch, x):
    """One bf16 ulp at each element of ``x`` (f32)."""
    a = x.float().abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def compare_train_step_on_cpu(torch, step, state, batch, dev):
    """Step 1 on the card and the same call on a host copy of the state:
    loss and grad norm within STEP_RTOL, and the share of params within one
    bf16 ulp of the CPU's at least ULP_SHARE. Returns (state', metrics)."""
    from repro_torch.tree import leaves, tree_map
    cpu_state = tree_map(lambda t: t.cpu(), state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu_state, cm = step(cpu_state, batch)
    cpu_s = time.perf_counter() - t0
    if cpu_s > TRAIN_CPU_BUDGET_S:
        fail(f"the CPU train step took {cpu_s!r} s, over its "
             f"{TRAIN_CPU_BUDGET_S} s budget")
    for k in ("loss", "grad_norm", "lr"):
        got, want = float(m[k]), float(cm[k])
        log(f"[verify] train step 1 ({SHORT_B}x{SHORT_T} tokens) {k}: card "
            f"{got!r}, CPU {want!r}, relative {abs(got - want) / abs(want)!r} "
            f"(limit {STEP_RTOL})")
        if not abs(got - want) <= STEP_RTOL * abs(want):
            fail(f"train step 1 {k} on the card {got!r} differs from the "
                 f"CPU's {want!r}")
    within = total = 0
    worst = 0.0
    for (name, g), (_, c) in zip(leaves(state.params), leaves(cpu_state.params)):
        c = c.to(dev)
        d = (g.float() - c.float()).abs()
        within += int((d <= bf16_ulp(torch, c)).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    share = within / total
    log(f"[verify] train step 1 params: {within} of {total} within one bf16 "
        f"ulp of the CPU's, share {share!r} (limit {ULP_SHARE}); max|d| "
        f"{worst!r}; card {card_ms!r} ms, CPU {cpu_s!r} s")
    if share < ULP_SHARE:
        fail(f"only {share!r} of the params after step 1 are within one bf16 "
             f"ulp of the CPU's")
    return state, m


def check_train_kernels(torch, kern, records):
    """Each kernel against its plain version at every distinct shape phase 7
    gave it, on fresh random operands of that shape and dtype: block_gather
    and block_scatter byte for byte, block_norms exactly on dyadic values."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)

    def rand(shape, dtype):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g, device=dev).to(dtype)
        return torch.randint(-1000, 1000, shape, generator=g, device=dev).to(dtype)

    def ids_for(x_shape, bs, k):
        n_tiles = -(-x_shape[0] // bs[0]) * -(-x_shape[1] // bs[1])
        return torch.randperm(n_tiles, generator=g, device=dev)[:k].to(torch.int32)

    done = {}
    gathers = sorted({(x[0], x[1], ids[0][0], bs)
                      for x, ids, bs in records["block_gather"]}, key=str)
    for shape, dtype, k, bs in gathers:
        x = rand(shape, dtype)
        ids = ids_for(shape, bs, k)
        got, want = kern.block_gather.launch(x, ids, bs), kern.block_gather.plain(x, ids, bs)
        if not same_bytes(got, want):
            fail(f"block_gather at the train shape {shape} {dtype} K={k} {bs}: "
                 f"max diff {max_abs_err(got, want)}")
    done["block_gather"] = len(gathers)
    norms = sorted({(x[0], x[1], bs) for x, bs in records["block_norms"]}, key=str)
    for shape, dtype, bs in norms:
        x = torch.randint(-3, 4, shape, generator=g, device=dev).to(dtype).div_(8)
        got, want = kern.block_norms.launch(x, bs), kern.block_norms.plain(x, bs)
        if not torch.equal(got, want):
            fail(f"block_norms at the train shape {shape} {dtype} {bs}: max "
                 f"diff {max_abs_err(got, want)}")
    done["block_norms"] = len(norms)
    # (base, ids, blocks, ("inplace", flag))
    scatters = sorted({(r[0][0], r[0][1], r[1][0][0], r[2][0], r[2][1],
                        tuple(r[3:])) for r in records["block_scatter"]},
                      key=str)
    for shape, dtype, k, b_shape, b_dtype, kw in scatters:
        base = rand(shape, dtype)
        bs = b_shape[1:]
        ids = ids_for(shape, bs, k)
        blocks = rand(b_shape, b_dtype)
        got = kern.block_scatter.launch(base.clone(), ids, blocks, **dict(kw))
        want = kern.block_scatter.plain(base.clone(), ids, blocks, **dict(kw))
        if not same_bytes(got, want):
            fail(f"block_scatter at the train shape {shape} {dtype} K={k}: "
                 f"max diff {max_abs_err(got, want)}")
    done["block_scatter"] = len(scatters)
    torch.cuda.synchronize()
    log(f"[check] train shapes against the plain versions, max diff 0: "
        f"distinct shapes {json.dumps(done)}; block_gather "
        f"{[(s, str(d), k, b) for s, d, k, b in gathers]}")


def time_train_gather(torch, kern, gathers):
    """The restore's largest block_gather (by bytes moved), timed beside
    index_select and its bound; returns (ms, library_ms, bound_ms, what)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    shape, dtype, k, bs = max(
        gathers, key=lambda s: s[2] * s[3][1] * torch.empty((), dtype=s[1]).element_size())
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    ids = torch.randperm(shape[0], generator=g, device=dev)[:k].to(torch.int32)
    ids64 = ids.to(torch.int64)
    nbytes = k * bs[1] * x.element_size()
    bound = (2 * nbytes + 4 * k) / HBM_BYTES_PER_S * 1e3
    k_t, lib_t = time_pair_ms(lambda: kern.block_gather.launch(x, ids, bs),
                              lambda: x.index_select(0, ids64), 10)
    what = f"K={k} {bs} {dtype}"
    log(f"[time] block_gather at the restore's largest shape ({what}): kernel "
        f"{spread(k_t)}, library {spread(lib_t)}, bound {bound!r} ms (bytes)")
    return k_t, lib_t, bound, what


def train_path(torch, np, layers, workdir):
    """7: granite-3-8b trained on the card from an FTSF token corpus: plain
    steps (step 1 held to the CPU), a checkpoint through DeltaCheckpointer
    with an async save, an injected failure, a restore onto the card
    (block_gather), a resumed step and an elastic slice restore, then the
    compressed step over 2 pods (block_norms, block_gather, block_scatter).
    Returns the phase's launches and the restore gather's timing."""
    from repro_torch import kernels as kern
    from repro_torch.core import DeltaTensorStore
    from repro_torch.data.pipeline import FTSFLoader, write_token_dataset
    from repro_torch.data.synthetic import token_stream
    from repro_torch.lake import LocalFSObjectStore
    from repro_torch.models import transformer as tt
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer
    from repro_torch.tree import leaves, tree_map

    dev = torch.device("cuda")
    cfg = serve_config(layers)
    ocfg = opt.OptConfig(**TRAIN_OPT)
    data = DeltaTensorStore(LocalFSObjectStore(str(workdir / "data")),
                            "datasets", device=dev)
    write_token_dataset(data, token_stream(TRAIN_SAMPLES, TRAIN_T,
                                           cfg.vocab_size, seed=0),
                        tensor_id="corpus")
    loader = FTSFLoader(data, "corpus", batch_size=TRAIN_B, seed=0)
    batches = iter(loader)

    def next_batch():
        b = next(batches)
        return {k: torch.as_tensor(b[k]).to(dev) for k in ("tokens", "labels")}

    records, undo = recording_launches(
        torch, (kern.block_gather, kern.block_norms, kern.block_scatter))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kern)
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        state = trainer.init_state(cfg, gen, device=dev)
        n_params = tt.param_count(state.params)
        state_bytes = sum(t.numel() * t.element_size() for _, t in leaves(state))
        log(f"[train] {cfg.name} at published widths, {cfg.dtype}, depth cut to "
            f"L = {layers} of 40: {n_params} parameters; TrainState "
            f"{len(leaves(state))} leaves, {state_bytes} B (bf16 params, f32 m "
            f"and v); batches {TRAIN_B}x{TRAIN_T} from an FTSF corpus of "
            f"{TRAIN_SAMPLES} rows through FTSFLoader; OptConfig {TRAIN_OPT}")
        step = trainer.make_train_step(cfg, ocfg)

        # step 1: a short batch, held to the same call on the CPU
        rng = np.random.default_rng(7)
        tok = rng.integers(0, cfg.vocab_size, (SHORT_B, SHORT_T)).astype(np.int32)
        lab = np.concatenate([tok[:, 1:], np.full((SHORT_B, 1), -1, np.int32)], 1)
        state, _ = compare_train_step_on_cpu(
            torch, step, state, {"tokens": torch.as_tensor(tok),
                                 "labels": torch.as_tensor(lab)}, dev)

        # steps 2-4 timed, step 5 profiled
        tokens = TRAIN_B * TRAIN_T
        step_ms, losses = [], []
        for i in (2, 3, 4):
            b = next_batch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        med = sorted(step_ms)[1] / 1e3
        flops = 6 * n_params * tokens
        log(f"[train] steps 2-4 ({tokens} tokens each): {step_ms} ms, losses "
            f"{losses}; median {med * 1e3!r} ms, {tokens / med!r} tokens/s, "
            f"model-FLOPs share {flops / med / PEAK_BF16_FLOPS!r} (6 N tokens "
            f"= {flops} FLOP a step over 989 TFLOP/s, the H100 SXM's dense bf16 "
            f"peak); peak device memory {torch.cuda.max_memory_allocated()} B")
        box = {}
        b5 = next_batch()

        def run5():
            box["out"] = step(state, b5)
        profile_call(torch, f"train step 5 ({tokens} tokens)", run5)
        state, m = box.pop("out")
        if not math.isfinite(float(m["loss"])):
            fail("non-finite loss at step 5")

        # checkpoint: async save, injected failure, restore, resume, slice, gc
        workroot = workdir.parent
        free = shutil.disk_usage(workroot).free
        log(f"[ckpt] {workroot}: {free} B free for a {state_bytes} B checkpoint")
        if free < 1.5 * state_bytes:
            fail(f"{workroot} has {free} B free; the checkpoint needs "
                 f"{int(1.5 * state_bytes)} B")

        class FailingFS(LocalFSObjectStore):
            """A local store that counts puts and fails after ``fail_after``."""
            fail_after = None
            puts = 0

            def put(self, key, data, *, if_absent=False):
                if self.fail_after is not None and self.puts >= self.fail_after:
                    raise IOError(f"injected fault after {self.puts} puts")
                super().put(key, data, if_absent=if_absent)
                self.puts += 1

        obj = FailingFS(str(workdir / "ckpt"))
        ck = ckpt_mod.DeltaCheckpointer(obj, device=dev)
        saved = tree_map(torch.clone, state)        # step 5, kept on the card
        b6 = next_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save_async(5, state)
        blocked = time.perf_counter() - t0
        state, m6 = step(state, b6)
        loss6 = float(m6["loss"])
        step6_ms = (time.perf_counter() - t0 - blocked) * 1e3
        ck.wait()
        save_s = time.perf_counter() - t0
        log(f"[ckpt] save_async of step 5: the loop blocked {blocked!r} s (the "
            f"host snapshot); step 6 during the upload {step6_ms!r} ms; commit "
            f"after {save_s!r} s, {state_bytes / save_s / 1e9!r} GB/s of state "
            f"bytes, {obj.puts} puts")

        obj.fail_after = obj.puts + 3
        try:
            ck.save(6, state)
        except IOError as e:
            log(f"[ckpt] save of step 6 failed as injected: {e}")
        else:
            fail("the injected fault did not fire")
        obj.fail_after = None
        fresh = ckpt_mod.DeltaCheckpointer(LocalFSObjectStore(str(workdir / "ckpt")),
                                           device=dev)
        if fresh.steps() != [5]:
            fail(f"after the failed save the store holds steps {fresh.steps()}")
        del state, m6
        torch.cuda.empty_cache()

        n_gather = len(records["block_gather"])
        before = kern.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        found, restored = fresh.restore(trainer.init_state(cfg, device="meta"),
                                        device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in kern.launch_counts().items()}
        restore_gathers = records["block_gather"][n_gather:]
        log(f"[ckpt] restore(device='cuda') of step {found}: {restore_s!r} s, "
            f"{state_bytes / restore_s / 1e9!r} GB/s of state bytes; launches "
            f"{json.dumps(launched)}")
        if found != 5 or launched["block_gather"] <= 0:
            fail("the restore did not bring step 5 back through block_gather")
        bad = [n for (n, a), (_, b) in zip(leaves(restored), leaves(saved))
               if not (a.is_cuda and same_bytes(a, b))]
        if bad:
            fail(f"restored leaves differ from the saved ones: {bad}")
        log(f"[verify] every restored leaf ({len(leaves(restored))}) is on the "
            f"card and byte-identical to the saved one, the 0-d step "
            f"{int(restored.step)} and opt/count {int(restored.opt.count)} "
            f"({restored.step.dtype}) included")

        puts = obj.puts
        t0 = time.perf_counter()
        ck.save(7, restored)
        incr_s = time.perf_counter() - t0
        manifest = ck._manifest(7)[1]
        if any(not tid.endswith("@5") for tid in manifest.values()):
            fail("the incremental save of an unchanged state uploaded tensors")
        log(f"[ckpt] incremental save of the unchanged state as step 7: "
            f"{incr_s!r} s, {obj.puts - puts} puts, every leaf re-pointed at "
            f"step 5's tensors")

        restored, mr = step(restored, b6)
        resumed = float(mr["loss"])
        log(f"[verify] resumed step 6 loss {resumed!r} against the "
            f"uninterrupted {loss6!r} (limit rtol {RESUME_RTOL})")
        if not abs(resumed - loss6) <= RESUME_RTOL * abs(loss6):
            fail("the resumed step's loss differs from the uninterrupted run's")
        del restored, mr
        half = cfg.vocab_size // 2
        _, part = fresh.restore(
            {"params": {"embed": torch.empty((half, cfg.d_model),
                                             dtype=torch.bfloat16,
                                             device="meta")}},
            step=5, shard_slices={"params/embed": [(0, half)]})
        if not same_bytes(part["params"]["embed"],
                           saved.params["embed"][:half]):
            fail("the elastic restore of half of params/embed differs")
        log(f"[verify] elastic restore of params/embed[:{half}] byte-identical")
        del part, saved
        # gc(keep=1) without its compact: compact would merge each tensor's
        # part files into one, through one zlib call over the whole tensor
        t0 = time.perf_counter()
        pruned = ck.prune(keep=1)
        vac = ck.store.vacuum()
        if ck.steps() != [7] or not ck.restore_available():
            fail(f"prune(keep=1) left steps {ck.steps()}")
        log(f"[ckpt] prune(keep=1) + vacuum: {time.perf_counter() - t0!r} s, "
            f"pruned {pruned}, {sum(r.files_deleted for r in vac)} files and "
            f"{sum(r.bytes_reclaimed for r in vac)} B reclaimed (the failed "
            f"save's orphans), steps left {ck.steps()}")
        torch.cuda.empty_cache()

        # the compressed step: 2 pods, ratio 0.05
        torch.cuda.reset_peak_memory_stats()
        cstate = trainer.init_compressed_state(cfg, gen, PODS, device=dev)
        cstep = trainer.make_compressed_train_step(cfg, ocfg, ratio=RATIO)

        def pod_batch():
            return {k: v.reshape(PODS, TRAIN_B // PODS, TRAIN_T)
                    for k, v in next_batch().items()}
        cms = []
        for i in (1, 2, 3):
            b = pod_batch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cstate, cm = cstep(cstate, b)
            torch.cuda.synchronize()
            cms.append((time.perf_counter() - t0) * 1e3)
            apart = [n for n, p in leaves(cstate.params)
                     if not same_bytes(p[0], p[1])]
            if apart:
                fail(f"compressed step {i}: pods differ on {apart}")
            if not (cm["wire_ratio"] < WIRE_LIMIT and math.isfinite(float(cm["loss"]))):
                fail(f"compressed step {i}: wire ratio {cm['wire_ratio']!r}, "
                     f"loss {float(cm['loss'])!r}")
            log(f"[train] compressed step {i} ({PODS} pods x {TRAIN_B // PODS}x"
                f"{TRAIN_T}): {cms[-1]!r} ms, loss {float(cm['loss'])!r}, wire "
                f"ratio {cm['wire_ratio']!r}, pods byte-identical")
        counts = kern.launch_counts()
        b_prof = pod_batch()
    finally:
        undo()
        loader.close()
    log(f"[train] compressed steps {cms} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    log(f"[train] launches over phase 7: {json.dumps(counts)}; block_gather by "
        f"variant {json.dumps(kern.block_gather.variant_launches)}; restore "
        f"block_gather {launched['block_gather']}")
    for name in COMPRESS_KERNELS + ("adamw",):
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the training path")
    box = {}

    def run_compressed():
        box["out"] = cstep(cstate, b_prof)
    profile_call(torch, "compressed train step", run_compressed)
    del cstate, box
    torch.cuda.empty_cache()
    check_train_kernels(torch, kern, records)
    times = time_train_gather(torch, kern, sorted(
        {(x[0], x[1], ids[0][0], bs) for x, ids, bs in restore_gathers}, key=str))
    return counts, times


# -- phase 7b: training the deep families ------------------------------------------

DEEP_B, DEEP_T = 8, 256          # a step's batch; T a multiple of ssm_chunk (128)
DEEP_SAMPLES = 128               # token rows in their corpus (16 batches)
DEEP_VOCAB = 32000               # corpus tokens below both models' vocabularies
REMAT_SUPERS = 2                 # zamba2 super-blocks in 7b(a): 14 layers
REMAT_GRAD_TOL = 1e-6            # a leaf's max|d| over its max|g|, remat or not
DEEP_CPU_T = 128                 # 7b(b): one 1x128 batch, on the card and the CPU
DEEP_STEP_RTOL = 1e-3            # 7b(b): loss and grad norm, f32 both sides
DEEP_STEPS = 5                   # 7b(c): plain steps at published depth
WHISPER_STEPS = 3                # 7b(d): plain, then compressed steps
SERVE_CLI = ["--arch", "whisper-tiny", "--ckpt-gc-keep", "1",
             "--requests", "8", "--slots", "4"]


def deep_configs():
    """(zamba2-2.7b, whisper-tiny) at their published widths and depth
    (src/repro/configs/zamba2_2_7b.py: 54 Mamba2 layers, the shared
    attention block before every 6, d_model 2560, vocab 32000;
    whisper_tiny.py: 4 encoder + 4 decoder layers, d_model 384, vocab
    51865), bf16, each super-block and encoder layer rematerialised under
    their configs' ``remat_policy``, ``nothing_saveable``."""
    from repro_torch.models import get_arch
    return get_arch("zamba2-2.7b"), get_arch("whisper-tiny")


def nbytes(torch, tree) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for _, t in leaves(tree))


def remat_parity(torch, tt, cfg, batch):
    """7b(a): one forward and backward of zamba2 cut to REMAT_SUPERS
    super-blocks, with and without remat, on the same weights and batch:
    equal loss, every gradient leaf byte-identical or within REMAT_GRAD_TOL
    of its max|g|, and a lower peak with remat. Returns (activation bytes
    saved per super-block, the no-remat step's transient bytes)."""
    import dataclasses
    from repro_torch.tree import leaves, rebuild
    cut = dataclasses.replace(cfg, n_layers=REMAT_SUPERS * cfg.shared_attn_every)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tt.init_params(cut, gen, device="cuda")
    flat = [p.detach().requires_grad_() for _, p in leaves(params)]
    with torch.enable_grad():   # a warm-up, so neither variant times it
        torch.autograd.grad(tt.loss_fn(rebuild(params, iter(flat)), cut,
                                       batch)[0], flat)
    out = {}
    for policy in ("nothing_saveable", "everything_saveable"):
        c = dataclasses.replace(cut, remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        flat = [p.detach().requires_grad_() for _, p in leaves(params)]
        t0 = time.perf_counter()
        with torch.enable_grad():
            total, _ = tt.loss_fn(rebuild(params, iter(flat)), c, batch)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - base
            grads = torch.autograd.grad(total, flat)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        out[policy] = (total.detach(), grads, held, peak - base, peak, ms)
        del flat, total
    loss_r, g_r, held_r, inc_r, peak_r, ms_r = out["nothing_saveable"]
    loss_e, g_e, held_e, inc_e, peak_e, ms_e = out["everything_saveable"]
    names = [n for n, _ in leaves(params)]
    identical, apart, worst = 0, [], 0.0
    for n, a, b in zip(names, g_r, g_e):
        if same_bytes(a, b):
            identical += 1
            continue
        top = float(b.float().abs().max())
        d = float((a.float() - b.float()).abs().max())
        worst = max(worst, d / max(top, 1e-30))
        apart.append((n, d, top))
    grad_bytes = nbytes(torch, list(g_r))
    per_super = (held_e - held_r) / REMAT_SUPERS
    log(f"[remat] zamba2-2.7b at published widths, {cut.dtype}, depth cut to "
        f"{REMAT_SUPERS} super-blocks ({cut.n_layers} Mamba2 layers and "
        f"{REMAT_SUPERS} applications of the shared attention block), "
        f"{tt.param_count(params)} parameters, batch {DEEP_B}x{DEEP_T}: "
        f"loss with remat {float(loss_r)!r}, without {float(loss_e)!r}; "
        f"{identical} of {len(names)} gradient leaves byte-identical, the "
        f"others {[(n, d, top) for n, d, top in apart]} (max|d| / max|g| "
        f"{worst!r}, limit {REMAT_GRAD_TOL})")
    log(f"[remat] activations held after the forward pass: {held_r} B with "
        f"remat, {held_e} B without; peak {peak_r} B with remat (+{inc_r} B "
        f"over the params), {peak_e} B without (+{inc_e} B); step {ms_r!r} "
        f"ms with remat, {ms_e!r} ms without; saved per super-block "
        f"{per_super!r} B")
    if not torch.equal(loss_r, loss_e):
        fail(f"remat changed the loss: {float(loss_r)!r} against "
             f"{float(loss_e)!r}")
    if worst > REMAT_GRAD_TOL:
        fail(f"remat changed gradient leaves beyond {REMAT_GRAD_TOL} of their "
             f"max|g|: {apart}")
    if not peak_r < peak_e:
        fail(f"remat did not lower the peak: {peak_r} B against {peak_e} B")
    transient = inc_e - grad_bytes - held_e
    del params, out, g_r, g_e
    torch.cuda.empty_cache()
    return per_super, transient


def deep_step_on_cpu(torch, np, trainer, opt, cfg):
    """7b(b): step 1 of zamba2 cut to one super-block (7 layers) at
    published widths, in f32 on the card and on the CPU from the same
    state: loss and grad norm within DEEP_STEP_RTOL."""
    import dataclasses
    from repro_torch.tree import tree_map
    cut = dataclasses.replace(cfg, n_layers=cfg.shared_attn_every,
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(2)
    state = trainer.init_state(cut, gen, device="cuda")
    cpu_state = tree_map(lambda t: t.cpu(), state)
    rng = np.random.default_rng(8)
    tok = rng.integers(0, cut.vocab_size, (1, DEEP_CPU_T)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], np.full((1, 1), -1, np.int32)], 1)
    batch = {"tokens": torch.as_tensor(tok), "labels": torch.as_tensor(lab)}
    step = trainer.make_train_step(cut, opt.OptConfig(**TRAIN_OPT))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu_state, cm = step(cpu_state, batch)
    cpu_s = time.perf_counter() - t0
    if cpu_s > TRAIN_CPU_BUDGET_S:
        fail(f"the CPU step took {cpu_s!r} s, over its {TRAIN_CPU_BUDGET_S} s "
             f"budget")
    for k in ("loss", "grad_norm"):
        got, want = float(m[k]), float(cm[k])
        rel = abs(got - want) / abs(want)
        log(f"[verify] zamba2-2.7b step 1, one super-block ({cut.n_layers} "
            f"Mamba2 layers and the shared attention block), f32, "
            f"1x{DEEP_CPU_T} tokens, {k}: card {got!r}, CPU {want!r}, "
            f"relative {rel!r} (limit {DEEP_STEP_RTOL}); card {card_ms!r} ms, "
            f"CPU {cpu_s!r} s")
        if not rel <= DEEP_STEP_RTOL:
            fail(f"zamba2 step 1 {k} on the card {got!r} differs from the "
                 f"CPU's {want!r}")
    del state, cpu_state
    torch.cuda.empty_cache()


def zamba2_steps(torch, tt, trainer, opt, cfg, next_batch, per_super,
                 transient):
    """7b(c): DEEP_STEPS plain steps of zamba2-2.7b at published depth and
    widths with remat: step ms, tokens/s, model-FLOPs share, peak memory,
    one profiled step; the peak without remat estimated from 7b(a)."""
    n_super = cfg.n_layers // cfg.shared_attn_every
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(3)
    state = trainer.init_state(cfg, gen, device="cuda")
    n_params = tt.param_count(state.params)
    state_bytes = nbytes(torch, state)
    step = trainer.make_train_step(cfg, opt.OptConfig(**TRAIN_OPT))
    tokens = DEEP_B * DEEP_T
    ms, losses, norms = [], [], []
    box = {}
    for i in range(1, DEEP_STEPS + 1):
        b = next_batch()
        if i == DEEP_STEPS:
            def run():
                box["out"] = step(state, b)
            profile_call(torch, f"zamba2-2.7b train step {i} ({tokens} "
                         f"tokens, 54 layers, remat)", run)
            state, m = box.pop("out")
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if not (math.isfinite(losses[-1]) and math.isfinite(norms[-1])):
            fail(f"zamba2 step {i}: loss {losses[-1]!r}, grad norm {norms[-1]!r}")
    peak = torch.cuda.max_memory_allocated()
    med = sorted(ms[1:])[len(ms[1:]) // 2] / 1e3
    flops = 6 * n_params * tokens
    grads = 2 * n_params          # bf16 gradients
    est = state_bytes + grads + n_super * per_super + transient
    log(f"[train zamba2] zamba2-2.7b at published depth and widths: "
        f"{n_params} parameters, TrainState {state_bytes} B; {DEEP_STEPS} "
        f"steps of {DEEP_B}x{DEEP_T} tokens from FTSFLoader: step ms {ms} "
        f"(steps 1-{DEEP_STEPS - 1}; step {DEEP_STEPS} profiled), losses "
        f"{losses}, grad norms {norms}; median of steps 2-{DEEP_STEPS - 1} "
        f"{med * 1e3!r} ms, {tokens / med!r} tokens/s, model-FLOPs share "
        f"{flops / med / PEAK_BF16_FLOPS!r} (6 N tokens = {flops} FLOP a step "
        f"over 989 TFLOP/s); peak device memory with remat {peak} B")
    log(f"[train zamba2] estimated peak of a 54-layer step without remat: "
        f"{est!r} B = TrainState {state_bytes} + bf16 grads {grads} + "
        f"{n_super} super-blocks x {per_super!r} B saved + the step's "
        f"transient {transient} B (7b(a)); not run")
    del state, box
    torch.cuda.empty_cache()


def whisper_path(torch, np, tt, trainer, opt, cfg, next_batch, workdir):
    """7b(d): whisper-tiny trained at published depth and widths (plain
    steps, then compressed steps over 2 pods), its TrainState checkpointed
    and restored onto the card, then served from that checkpoint by
    ``repro_torch.launch.serve`` and compared with an in-process engine.
    Returns the kernels' launch records."""
    from repro_torch import kernels as kern
    from repro_torch.lake import LocalFSObjectStore
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.layers import dtype_of
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.tree import leaves
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    frames = torch.randn((DEEP_B, WHISPER_FRAMES, cfg.d_model), generator=gen,
                         device=dev).to(dtype_of(cfg.dtype))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(cfg, gen, device=dev)
    step = trainer.make_train_step(cfg, opt.OptConfig(**TRAIN_OPT))
    ms = []
    for i in range(1, WHISPER_STEPS + 1):
        b = dict(next_batch(), encoder_frames=frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss = float(m["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
        if not (math.isfinite(loss) and math.isfinite(float(m["grad_norm"]))):
            fail(f"whisper step {i}: loss {loss!r}")
    log(f"[train whisper] whisper-tiny at published depth and widths, "
        f"{tt.param_count(state.params)} parameters, encoder_frames "
        f"{tuple(frames.shape)} {frames.dtype}: {WHISPER_STEPS} plain steps of "
        f"{DEEP_B}x{DEEP_T} tokens, {ms} ms, last loss {loss!r}")

    cstate = trainer.init_compressed_state(cfg, gen, PODS, device=dev)
    cstep = trainer.make_compressed_train_step(cfg, opt.OptConfig(**TRAIN_OPT),
                                               ratio=RATIO)
    records, undo = recording_launches(
        torch, (kern.block_gather, kern.block_norms, kern.block_scatter))
    try:
        cms = []
        for i in range(1, WHISPER_STEPS + 1):
            b = dict(next_batch(), encoder_frames=frames)
            b = {k: v.reshape((PODS, DEEP_B // PODS) + tuple(v.shape[1:]))
                 for k, v in b.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cstate, cm = cstep(cstate, b)
            torch.cuda.synchronize()
            cms.append((time.perf_counter() - t0) * 1e3)
            apart = [n for n, p in leaves(cstate.params)
                     if not same_bytes(p[0], p[1])]
            if apart:
                fail(f"whisper compressed step {i}: pods differ on {apart}")
            if not (cm["wire_ratio"] < WIRE_LIMIT
                    and math.isfinite(float(cm["loss"]))):
                fail(f"whisper compressed step {i}: wire ratio "
                     f"{cm['wire_ratio']!r}, loss {float(cm['loss'])!r}")
        log(f"[train whisper] {WHISPER_STEPS} compressed steps over {PODS} "
            f"pods at ratio {RATIO}: {cms} ms, last loss "
            f"{float(cm['loss'])!r}, wire ratio {cm['wire_ratio']!r}, pods "
            f"byte-identical; peak device memory "
            f"{torch.cuda.max_memory_allocated()} B")
        del cstate, cm
        vocab_rows = [x for x, _ in records["block_norms"]
                      if x[0] == (cfg.vocab_size, cfg.d_model)]
        if not vocab_rows:
            fail("block_norms never saw the (51865, 384) embedding leaf")

        ckdir = workdir / "ckpt"
        ck = ckpt_mod.DeltaCheckpointer(LocalFSObjectStore(str(ckdir)),
                                        device=dev)
        t0 = time.perf_counter()
        ck.save(WHISPER_STEPS, state)
        save_s = time.perf_counter() - t0
        before = kern.launch_counts()["block_gather"]
        t0 = time.perf_counter()
        found, restored = ck.restore(trainer.init_state(cfg, device="meta"),
                                     device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        gathered = kern.launch_counts()["block_gather"] - before
        bad = [n for (n, a), (_, b) in zip(leaves(restored), leaves(state))
               if not (a.is_cuda and same_bytes(a, b))]
        if found != WHISPER_STEPS or bad or gathered <= 0:
            fail(f"whisper restore: step {found}, differing leaves {bad}, "
                 f"block_gather launches {gathered}")
        log(f"[ckpt whisper] save {save_s!r} s, restore(device='cuda') "
            f"{restore_s!r} s through {gathered} block_gather launches; every "
            f"leaf ({len(leaves(restored))}) byte-identical")
    finally:
        undo()
    del state

    t0 = time.perf_counter()
    served = serve_cli.main(SERVE_CLI + ["--ckpt-dir", str(ckdir)])
    cli_s = time.perf_counter() - t0
    args = serve_cli.parse_args(SERVE_CLI)
    reqs = [Request(rid=r.rid, prompt=r.prompt.copy(),
                    max_new_tokens=args.max_new) for r in served]
    with ServeEngine(restored.params, cfg, n_slots=args.slots,
                     max_len=args.max_len) as eng:
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
    same = [r.rid for r, w in zip(served, reqs)
            if list(map(int, r.out_tokens)) == list(map(int, w.out_tokens))]
    log(f"[serve whisper] launch.serve over the checkpoint (--ckpt-gc-keep 1): "
        f"{len(served)} requests in {cli_s!r} s; tokens equal to an "
        f"in-process ServeEngine's ({args.slots} slots) for {len(same)} of "
        f"{len(reqs)}; first request {served[0].out_tokens}")
    if len(same) != len(reqs) or not all(r.done for r in served):
        fail("the serve CLI's tokens differ from the in-process engine's")
    if ck.steps() != [WHISPER_STEPS]:
        fail(f"the CLI's gc left steps {ck.steps()}")
    del restored
    torch.cuda.empty_cache()
    return records


def deep_train_path(torch, np, workdir):
    """7b: the deep families trained at published widths on the card.
    Returns {path: launch counts} for train_zamba2 and train_whisper."""
    from repro_torch import kernels as kern
    from repro_torch.core import DeltaTensorStore
    from repro_torch.data.pipeline import FTSFLoader, write_token_dataset
    from repro_torch.data.synthetic import token_stream
    from repro_torch.lake import LocalFSObjectStore
    from repro_torch.models import transformer as tt
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    zamba2, whisper = deep_configs()
    data = DeltaTensorStore(LocalFSObjectStore(str(workdir / "data")),
                            "datasets", device=dev)
    write_token_dataset(data, token_stream(DEEP_SAMPLES, DEEP_T, DEEP_VOCAB,
                                           seed=1), tensor_id="corpus")
    loader = FTSFLoader(data, "corpus", batch_size=DEEP_B, seed=1)
    batches = iter(loader)

    def next_batch():
        b = next(batches)
        return {k: torch.as_tensor(b[k]).to(dev) for k in ("tokens", "labels")}

    paths = {}
    try:
        torch.cuda.synchronize()
        reset_counts(kern)
        per_super, transient = remat_parity(torch, tt, zamba2, next_batch())
        deep_step_on_cpu(torch, np, trainer, opt, zamba2)
        zamba2_steps(torch, tt, trainer, opt, zamba2, next_batch, per_super,
                     transient)
        paths["train_zamba2"] = kern.launch_counts()
        log(f"[train zamba2] launches over 7b(a)-(c): "
            f"{json.dumps(paths['train_zamba2'])} (the model runs no kernel of "
            f"this repo; its optimizer runs adamw)")

        torch.cuda.synchronize()
        reset_counts(kern)
        records = whisper_path(torch, np, tt, trainer, opt, whisper,
                               next_batch, workdir)
        paths["train_whisper"] = kern.launch_counts()
    finally:
        loader.close()
    log(f"[train whisper] launches over 7b(d): "
        f"{json.dumps(paths['train_whisper'])}")
    for name in COMPRESS_KERNELS + ("adamw",):
        if paths["train_whisper"][name] <= 0:
            fail(f"kernel {name} was not launched on whisper's training path")
    if paths["train_zamba2"]["adamw"] <= 0:
        fail("adamw was not launched on zamba2's training path")
    check_train_kernels(torch, kern, records)
    log(f"[train] phase 7b: {time.perf_counter() - t_phase!r} s")
    return paths


# -- phase 8: the mesh tooling ----------------------------------------------------

# one rank of each cell on the card under a fake process group: whisper-tiny
# on the (4, 4) mesh the reference's smoke test compiles, granite-3-8b and
# the recurrent families on the production (16, 16) mesh, and on the
# multi-pod (2, 16, 16) one, where 2 model ranks share each row and split its
# heads; "<arch>@<L>" is the arch cut to L layers (the dry run's --layers),
# one super-block each of xlstm (7 mLSTM + 1 sLSTM) and zamba2 (shared
# attention + 6 Mamba2), the time limit
MESH_CELLS = (("xlstm-1.3b@8", "train_4k", "single"),    # the longest first
              ("xlstm-1.3b@8", "train_4k", "multi"),
              ("whisper-tiny", "train_4k", "4x4"),
              ("granite-3-8b", "train_4k", "single"),
              ("zamba2-2.7b@6", "train_4k", "single"),
              ("zamba2-2.7b@6", "train_4k", "multi"),
              # 8d: the serving cells, decode on a cache split on seq (the
              # flash-decode combine), MoE at T = 1 over a ring cache, and
              # the hybrid's heads-split caches beside its Mamba2 states
              ("granite-3-8b", "decode_32k", "single"),
              ("mixtral-8x22b", "long_500k", "single"),
              ("zamba2-2.7b", "long_500k", "single"))
FLOPS_RATIO = (1.0, 2.0)   # 8c: counted FLOPs over model_flops core + attention
DRYRUN_S = 600
CARD_RUNS = 3      # 8b's dry runs on the card at once
# 8b: one device's FLOPs in the JAX reference's step of each train cell, from
# tools/reference_rank_flops.py (repro.analysis.hlo_cost of the step XLA
# compiles for host CPU devices, Auto mesh axes; jax 0.9.0; --layers for a
# cut arch). A rank of the port may count at most SHARE_LIMIT times as many.
REFERENCE_RANK_FLOPS = {
    ("whisper-tiny", "train_4k", "4x4"): 34330411794432.0,
    ("granite-3-8b", "train_4k", "single"): 294532079943680.0,
    ("xlstm-1.3b@8", "train_4k", "single"): 13659271069696.0,
    ("zamba2-2.7b@6", "train_4k", "single"): 14922326999040.0,
    # --mesh 2x16x16: ("pod", "data", "model"), 512 host devices
    ("xlstm-1.3b@8", "train_4k", "multi"): 6829635534848.0,
    ("zamba2-2.7b@6", "train_4k", "multi"): 7461163499520.0}
SHARE_LIMIT = 1.10
# granite-3-8b x train_4k, rank 0 of (16, 16) on the H100 while each op chose
# its own layout (the stream split on d): the stream's layout may not move
# more bytes or peak higher
PER_OP_GRANITE = {"flops": 834668677038080.0, "peak_bytes": 26615210496,
                  "collectives_gb": {"all_reduce": 536.81, "all_gather": 112.22,
                                     "reduce_scatter": 21.95}}
DECODE_B, DECODE_PROMPT, DECODE_STEPS = 8, 64, 8   # 8e


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_cells(workdir, metas):
    """8b: each cell as rank 0 of its mesh on the card, one process each,
    CARD_RUNS of them at once: they build their cells and count a step
    side by side, and each times its step with the card to itself (the dry
    run's ``--lock``); and the same cells on meta, which
    :func:`start_dryrun` started beside 8a. Returns {cell: {device:
    record}}."""
    lock = workdir / "card.lock"
    out = {cell: {} for cell in MESH_CELLS}
    pending = list(MESH_CELLS)
    jobs = {(cell, "meta"): job for cell, job in metas.items()}
    while pending or jobs:
        while pending and sum(d == "cuda" for _, d in jobs) < CARD_RUNS:
            cell = pending.pop(0)
            jobs[cell, "cuda"] = start_dryrun(workdir, cell, "cuda", lock)
        done = [key for key, (proc, _, t0) in jobs.items()
                if proc.poll() is not None
                or time.perf_counter() - t0 > DRYRUN_S]
        for cell, device in done:
            out[cell][device] = finish_dryrun(workdir, cell, device,
                                              jobs.pop((cell, device)))
        if not done:
            time.sleep(0.2)
    return out


def start_dryrun(workdir, cell, device, lock=None):
    """Start ``python -m repro_torch.launch.dryrun`` for one cell of
    MESH_CELLS ("<arch>@<L>" cut to L layers) on ``device``."""
    arch, shape, mesh = cell
    base, _, layers = arch.partition("@")
    log_f = open(workdir / f"{arch}_{mesh}_{device}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", base,
         "--layers", layers or "0", "--shape", shape, "--mesh", mesh,
         "--device", device, "--out", str(workdir), "--force"]
        + (["--lock", str(lock)] if lock else []),
        env=dict(os.environ, PYTHONPATH=str(SRC)), stdout=log_f,
        stderr=subprocess.STDOUT, cwd=str(ROOT))
    CHILDREN.append(proc)
    return proc, log_f, time.perf_counter()


def finish_dryrun(workdir, cell, device, job):
    """Wait for a dry run that :func:`start_dryrun` started (at most
    DRYRUN_S) and return its record; fail where it has none."""
    proc, log_f, t0 = job
    try:
        proc.wait(timeout=max(0.0, DRYRUN_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log_f.close()
    log(f"[dryrun {' x '.join(cell)}] {device} process done "
        f"{time.perf_counter() - t0!r} s after its start")
    arch, shape, mesh = cell
    rec_path = workdir / f"{arch}__{shape}__{mesh}__{device}.json"
    text = (workdir / f"{arch}_{mesh}_{device}.log").read_text()
    if proc.returncode != 0 or not rec_path.exists():
        fail(f"dry run {cell} on {device}: exit {proc.returncode}\n"
             f"{text[-3000:]}")
    return json.loads(rec_path.read_text())


def kv_shard_bytes(arch, shape, mesh_name):
    """One layer's k shard on a rank of a decode cell: the cell's cache,
    laid out by the serve-state rules on the mesh's dim names and sizes."""
    import math as m
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import get_arch, transformer
    from repro_torch.tree import leaves
    cfg = get_arch(arch)
    info = specs.SHAPES[shape]
    b = info["global_batch"]
    ring = cfg.window is not None and shape == "long_500k"
    caches = transformer.init_caches(cfg, b, cfg.window if ring else
                                     info["seq_len"], device="meta")
    mesh = shd.AbstractMesh(*dryrun.mesh_of(mesh_name))
    sizes = shd.mesh_sizes(mesh)
    sh = dict(leaves(specs._cache_shardings(caches, cfg, mesh, b)))
    name, k = next((n, x) for n, x in leaves(caches) if n.endswith("/k"))
    local = [n // m.prod(sizes[a] for a in ((e,) if isinstance(e, str) else
                                            e or ()))
             for n, e in zip(k.shape, sh[name].spec)]
    return m.prod(local[k.ndim - 4:]) * k.element_size()


def decode_on_mesh(torch, np, cfg, mesh, dev):
    """8e: prefill DECODE_B x DECODE_PROMPT corpus tokens and take
    DECODE_STEPS greedy decode steps, plainly and on ``mesh`` (params and
    caches placed by the rules, the steps under the mesh), from the same
    params: every logit and cache byte must agree. Returns the steps' ms
    on the mesh."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.data.synthetic import token_stream
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.models import transformer as tt
    from repro_torch.tree import leaves, rebuild

    def place(tree, shardings):
        return rebuild(tree, iter([
            distribute_tensor(x, sh.mesh, sh.placements, src_data_rank=None)
            for (_, x), (_, sh) in zip(leaves(tree), leaves(shardings))]))

    def local(x):
        return x.to_local() if isinstance(x, DTensor) else x

    max_len = DECODE_PROMPT + DECODE_STEPS
    tok = torch.as_tensor(token_stream(DECODE_B, DECODE_PROMPT,
                                       cfg.vocab_size, seed=1)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tt.init_params(cfg, gen, device=dev)
    with torch.no_grad():
        caches = tt.init_caches(cfg, DECODE_B, max_len, device=dev)
        logits, caches, _ = tt.prefill(params, cfg, tok, caches)
        want, nxt = [logits], [logits[:, -1:].argmax(-1)]
        for _ in range(DECODE_STEPS):
            logits, caches, _ = tt.decode_step(params, cfg, nxt[-1], caches)
            want.append(logits)
            nxt.append(logits.argmax(-1))
        p = place(params, shd.params_shardings(params, cfg, mesh))
        del params
        c = tt.init_caches(cfg, DECODE_B, max_len, device=dev)
        c = place(c, specs._cache_shardings(c, cfg, mesh, DECODE_B))
        with shd.use_mesh(mesh), implicit_replication():
            logits, c, _ = tt.prefill(p, cfg, tok, c)
            got = [logits]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(DECODE_STEPS):
                logits, c, _ = tt.decode_step(p, cfg, nxt[i], c)
                got.append(logits)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if not same_bytes(local(a), b)]
    bad_c = [n for (n, a), (_, b) in zip(leaves(c), leaves(caches))
             if not same_bytes(local(a), b)]
    log(f"[mesh decode] {cfg.name} L = {cfg.n_layers} on a (1, 1) mesh, a "
        f"1-rank NCCL group: prefill {DECODE_B}x{DECODE_PROMPT}, "
        f"{DECODE_STEPS} greedy steps; logits differing from the plain "
        f"decode's at calls {bad} of {len(want)}, cache leaves differing "
        f"{bad_c} of {len(leaves(caches))}; a step on the mesh "
        f"{step_ms!r} ms")
    if bad or bad_c:
        fail(f"the mesh decode differs from the plain decode: logits at "
             f"calls {bad}, cache leaves {bad_c}")
    return step_ms


def mesh_path(torch, np, layers, workdir):
    """8: the mesh tooling. (a) ``jit_train_step`` on a real 1-rank NCCL
    group and a (1, 1) mesh against ``make_train_step`` from the same
    granite-3-8b L-layer state and batch; (c) op_cost over that plain step
    against ``accounting.model_flops``; (e) a prefill and greedy decode on
    that mesh against the plain ones; (b, d) one rank of each MESH_CELLS
    cell on the card under a fake process group, against the same cell
    counted on meta. Returns the launches of (a), (c) and (e)."""
    import torch.distributed as dist
    from repro_torch import kernels as kern
    from repro_torch.analysis import accounting, op_cost
    from repro_torch.data.synthetic import token_stream
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer
    from repro_torch.tree import leaves, tree_map

    dev = torch.device("cuda")
    cfg = serve_config(layers)
    ocfg = opt.OptConfig(**TRAIN_OPT)
    tok = token_stream(TRAIN_SAMPLES, TRAIN_T, cfg.vocab_size, seed=0)[:TRAIN_B]
    lab = np.concatenate([tok[:, 1:], np.full((TRAIN_B, 1), -1, np.int32)], 1)
    batch = {"tokens": torch.as_tensor(tok).to(dev),
             "labels": torch.as_tensor(lab).to(dev)}
    reset_counts(kern)
    t_phase = time.perf_counter()
    # 8b's meta counts need no card: they run beside 8a, 8c and 8e
    metas = {cell: start_dryrun(workdir, cell, "meta") for cell in MESH_CELLS}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        gen = torch.Generator(device=dev).manual_seed(0)
        state = trainer.init_state(cfg, gen, device=dev)
        plain = tree_map(torch.clone, state)
        step = trainer.make_train_step(cfg, ocfg)
        # 8c: phase 7's step, counted
        box = {}
        cost = op_cost.analyze(lambda: box.update(out=step(plain, batch)))
        plain, pm = box.pop("out")
        torch.cuda.synchronize()
        # 8a: the mesh step from the same state
        mstep, placed = trainer.jit_train_step(cfg, ocfg, mesh, state)
        del state
        t0 = time.perf_counter()
        placed, mm = mstep(placed, batch)
        torch.cuda.synchronize()
        mesh_ms = (time.perf_counter() - t0) * 1e3
        for k in ("loss", "grad_norm", "lr"):
            got, want = float(mm[k]), float(pm[k])
            log(f"[mesh] step 1 {k}: jit_train_step {got!r}, make_train_step "
                f"{want!r}, relative {abs(got - want) / abs(want)!r} (limit "
                f"{STEP_RTOL})")
            if not abs(got - want) <= STEP_RTOL * abs(want):
                fail(f"the mesh step's {k} {got!r} differs from the plain "
                     f"step's {want!r}")
        within = total = same = 0
        for (name, p), (_, q) in zip(leaves(placed.params), leaves(plain.params)):
            p = p.to_local()
            d = (p.float() - q.float()).abs()
            within += int((d <= bf16_ulp(torch, q)).sum())
            total += d.numel()
            same += same_bytes(p, q)
        share = within / total
        log(f"[mesh] (1, 1) mesh on a 1-rank NCCL group, every placement "
            f"Replicate: {within} of {total} params within one bf16 ulp of "
            f"make_train_step's, share {share!r} (limit {ULP_SHARE}); "
            f"byte-identical leaves {same} of {len(leaves(plain.params))}; "
            f"the mesh step {mesh_ms!r} ms (its first call: DTensor's "
            f"sharding propagation included)")
        if share < ULP_SHARE:
            fail(f"only {share!r} of the mesh step's params are within one "
                 f"bf16 ulp of the plain step's")
        del placed, mm
        torch.cuda.empty_cache()
        # 8c: counted FLOPs against the analytic ones; a warm step's time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain, _ = step(plain, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        model = accounting.model_flops(cfg, "train", TRAIN_B, TRAIN_T)
        want = model["model_flops"] + model["attn_flops"]
        ratio = cost.flops / want
        log(f"[op_cost] {cfg.name} L = {layers}, {TRAIN_B}x{TRAIN_T} tokens: "
            f"counted {cost.flops!r} FLOPs, {cost.bytes!r} bytes (no fusion), "
            f"collectives {json.dumps(cost.coll_bytes)}; model_flops "
            f"{model['model_flops']!r} + attn_flops {model['attn_flops']!r} = "
            f"{want!r}; ratio {ratio!r} (limits {FLOPS_RATIO}); a warm step "
            f"{step_s * 1e3!r} ms: counted FLOPs share "
            f"{cost.flops / step_s / PEAK_BF16_FLOPS!r}, 6 N D share "
            f"{model['model_flops'] / step_s / PEAK_BF16_FLOPS!r} of 989 "
            f"TFLOP/s")
        if not FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1]:
            fail(f"counted FLOPs over model_flops {ratio!r} outside "
                 f"{FLOPS_RATIO}")
        del plain
        torch.cuda.empty_cache()
        # 8e: serving on the same mesh
        decode_on_mesh(torch, np, cfg, mesh, dev)
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    counts = kern.launch_counts()
    torch.cuda.empty_cache()

    # 8b: one rank of each cell on the card, and the same cell on meta
    records = dryrun_cells(workdir, metas)
    for cell, recs in records.items():
        name = " x ".join(cell)
        for device, r in recs.items():
            if r["status"] != "ok":
                fail(f"dry run {name} on {device}: {r.get('error')}\n"
                     f"{r.get('traceback', '')[-2000:]}")
        cu, me = recs["cuda"], recs["meta"]
        c, m = cu["corrected"], me["corrected"]
        log(f"[dryrun {name}] rank 0 of {cu['n_devices']} ({cu['profile']}): "
            f"peak {cu['memory']['peak_allocated_bytes']} B, arguments "
            f"{cu['memory']['argument_size_in_bytes']} B, warm step "
            f"{cu['step_s'] * 1e3!r} ms; op_cost on the card: {c['flops']!r} "
            f"FLOPs, {c['bytes']!r} bytes, collectives "
            f"{json.dumps(c['coll_bytes'])} {json.dumps(c['coll_count'])}; on "
            f"meta: {m['flops']!r} FLOPs, {m['bytes']!r} bytes, collectives "
            f"{json.dumps(m['coll_bytes'])}; analytic model_flops "
            f"{cu['analytic']['model_flops']!r} over all ranks")
        if c["flops"] != m["flops"]:
            fail(f"dry run {name}: the card counted {c['flops']!r} FLOPs, "
                 f"meta {m['flops']!r}")
        if "row_share" in cu:
            log(f"[dryrun {name}] recurrent rows: {json.dumps(cu['row_share'])}")
        for op, v in list(cu["flops_by_op"].items())[:10]:
            log(f"[dryrun {name}]   FLOPs {op}: {v['flops']!r} in "
                f"{v['count']}")
        if cell in REFERENCE_RANK_FLOPS:
            share = c["flops"] / REFERENCE_RANK_FLOPS[cell]
            log(f"[dryrun {name}] counted FLOPs over the reference's rank "
                f"{REFERENCE_RANK_FLOPS[cell]!r}: {share!r} (limit "
                f"{SHARE_LIMIT})")
            if share > SHARE_LIMIT:
                fail(f"dry run {name}: a rank counts {share!r} times the "
                     f"reference's share of the FLOPs")
        coll = cu["collectives"]
        big = coll["largest"]
        log(f"[dryrun {name}] collectives on the card by kind (GB): "
            f"{json.dumps({k: v / 1e9 for k, v in coll['bytes_by_kind'].items()})}"
            f"; the largest single one {big['bytes']!r} B ({big['kind']}, "
            f"{big['op']})")
        by_op = sorted(((v["bytes"], kind, op, v["count"])
                        for kind, ops in coll["by_op"].items()
                        for op, v in ops.items()), reverse=True)
        for b, kind, op, n in by_op[:10]:
            log(f"[dryrun {name}]   {kind} {op}: {b / 1e9!r} GB in {n}")
        if cell == ("granite-3-8b", "train_4k", "single"):
            was = PER_OP_GRANITE
            total_gb = coll["total_bytes"] / 1e9
            peak = cu["memory"]["peak_allocated_bytes"]
            log(f"[dryrun {name}] with each op's own layout (GB): "
                f"{json.dumps(was['collectives_gb'])}, peak "
                f"{was['peak_bytes']} B, {was['flops']!r} FLOPs; now "
                f"{total_gb!r} GB, peak {peak} B")
            if total_gb > sum(was["collectives_gb"].values()) \
                    or peak > was["peak_bytes"]:
                fail(f"dry run {name}: {total_gb!r} GB of collectives, peak "
                     f"{peak} B, more than with each op's own layout")
        if specs.SHAPES[cell[1]]["kind"] == "decode":
            bound = kv_shard_bytes(*cell)
            log(f"[dryrun {name}] one layer's k shard on the rank {bound} B; "
                f"the largest collective {big['bytes']!r} B")
            if not big["bytes"] < bound:
                fail(f"dry run {name}: a collective of {big['bytes']!r} B "
                     f"({big['op']}) is as large as a layer's KV shard, "
                     f"{bound} B")
    log(f"[mesh] phase 8 {time.perf_counter() - t_phase!r} s; launches "
        f"{json.dumps(counts)}")
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
    times, dev_ms, compress_times = time_kernels(torch, kern, main)
    time_unshuffle_hook(torch, np, kern, ops)
    time_launch_path(torch, kern, _build)
    del main
    torch.cuda.empty_cache()
    adamw_row = check_adamw(torch, np, kern)

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
    torch.cuda.empty_cache()

    # 6b. serving the vlm, audio, ssm and hybrid families from the store
    families = families_path(torch, np, args.vlm_layers, workroot)
    for name, (counts, _) in families.items():
        paths[f"serve {name}"] = counts

    # 7. training granite-3-8b, with checkpoints in the store
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_", dir=workroot))
    try:
        paths["train"], train_gather = train_path(torch, np, args.layers, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # 7b. training zamba2-2.7b and whisper-tiny at published widths
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_deep_", dir=workroot))
    try:
        paths.update(deep_train_path(torch, np, workdir))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # 8. the mesh tooling: the mesh step, op_cost and one rank of each cell
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=workroot))
    try:
        paths["mesh"] = mesh_path(torch, np, args.layers, workdir)
    finally:
        stop_children()
        shutil.rmtree(workdir, ignore_errors=True)

    # 9. report
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
        by_family = {arch: fam_times[name] for arch, (_, fam_times)
                     in families.items() if name in fam_times}
        if by_family:
            row["serve_families"] = {
                arch: {"shape": what, "ms": ms[0], "library_ms": lib[0],
                       "bound_ms": bound}
                for arch, (ms, lib, bound, what) in by_family.items()}
        if name == "block_gather":
            t_ms, t_lib, t_bound, t_what = train_gather
            row.update(train_shape=t_what, train_ms=t_ms[0],
                       train_library_ms=t_lib[0], train_bound_ms=t_bound)
            row.update(compress_times)
        rows.append(row)
    rows.append({"name": "adamw", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/adamw.cu",
                 "replaces": None, "bound_by": "bytes",
                 "launches": sum(c["adamw"] for c in paths.values()),
                 "launches_by_path": {k: c["adamw"] for k, c in paths.items()},
                 **adamw_row})
    log(nvidia_smi_line())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
