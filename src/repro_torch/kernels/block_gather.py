"""block_gather: K (bh, bw) tiles of a 2-D operand at row-major grid ids.

``launch`` runs the CUDA kernel of ``csrc/block_gather.cu`` (the port of
the Pallas kernel ``repro/kernels/block_gather.py``); ``plain`` is the same
function in plain PyTorch, which the CPU path runs and the card checks the
kernel against. An id >= n_blocks gives a zero tile, a negative id tile 0,
and a ragged ``x`` reads as zero-padded to whole tiles.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from . import _build

launches = 0  # kernel launches since the last reset (set to 0 to reset)
_count_lock = threading.Lock()
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def _grid(x: torch.Tensor, block_shape: Tuple[int, int]):
    bh, bw = (int(b) for b in block_shape)
    if x.dim() != 2 or bh < 1 or bw < 1 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"block_gather wants a non-empty 2-D x and positive "
                         f"tiles, got {tuple(x.shape)} and {block_shape}")
    m, n = x.shape
    return m, n, bh, bw, -(-m // bh), -(-n // bw)


def plain(x: torch.Tensor, ids: torch.Tensor,
          block_shape: Tuple[int, int]) -> torch.Tensor:
    """(K, bh, bw) tiles of ``x`` at ``ids``, in plain PyTorch."""
    m, n, bh, bw, gh, gw = _grid(x, block_shape)
    dtype = x.dtype
    x = x.view(_SIGNED.get(dtype, dtype))  # CUDA indexing lacks uint16/32/64
    xp = torch.zeros((gh * bh, gw * bw), dtype=x.dtype, device=x.device)
    xp[:m, :n] = x
    bv = xp.reshape(gh, bh, gw, bw).permute(0, 2, 1, 3).reshape(gh * gw, bh, bw)
    ids = ids.to(device=x.device, dtype=torch.int64)
    out = bv[ids.clamp(0, gh * gw - 1)]
    valid = (ids < gh * gw).reshape(-1, 1, 1)
    out = torch.where(valid, out, torch.zeros((), dtype=x.dtype, device=x.device))
    return out.view(dtype)


def _word_bytes(*byte_counts: int) -> int:
    for w in (16, 8, 4, 2):
        if all(c % w == 0 for c in byte_counts):
            return w
    return 1


def launch(x: torch.Tensor, ids: torch.Tensor,
           block_shape: Tuple[int, int]) -> torch.Tensor:
    """(K, bh, bw) tiles of CUDA tensor ``x`` at ``ids``, by the kernel."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"block_gather kernel needs a CUDA tensor, got {x.device}")
    m, n, bh, bw, _, _ = _grid(x, block_shape)
    x = x.contiguous()
    ids = ids.to(device=x.device, dtype=torch.int32).contiguous().reshape(-1)
    k = ids.numel()
    out = torch.empty((k, bh, bw), dtype=x.dtype, device=x.device)
    if k == 0:
        return out
    eb = x.element_size()
    w = _word_bytes(x.data_ptr(), out.data_ptr(), n * eb, bw * eb)
    fn = _build.function("block_gather", "rt_block_gather",
                         [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 5
                         + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), ids.data_ptr(), out.data_ptr(), m, n * eb // w,
                 bh, bw * eb // w, k, w, stream)
    _build.check(err, "block_gather launch")
    with _count_lock:
        launches += 1
    return out
