"""block_scatter: K (bh, bw) tiles written over a 2-D operand at grid ids.

``launch`` runs the CUDA kernel of ``csrc/block_scatter.cu`` (the port of
the Pallas kernel ``repro/kernels/block_scatter.py``); ``plain`` is the same
function in plain PyTorch, which the CPU path runs and the card checks the
kernel against. Tile ``j`` lands at row-major grid id ``ids[j]``; an id in
``[-n_blocks, 0)`` counts from the end, any other id outside the grid
drops, tile parts beyond a ragged edge drop, and ``blocks`` is cast to
``base``'s dtype. Duplicate ids are unsupported.

``inplace=True`` writes into ``base`` itself (which must be contiguous) and
returns it, skipping the copy of ``base``: the gradient compressor scatters
into a zero buffer it has just made. Otherwise ``base`` is left as it is and
a new tensor is returned.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .block_gather import _SIGNED, _word_bytes

launches = 0  # kernel launches since the last reset (set to 0 to reset)
_count_lock = threading.Lock()


def _check(base: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor,
           inplace: bool):
    if base.dim() != 2 or base.shape[0] < 1 or base.shape[1] < 1:
        raise ValueError(f"block_scatter wants a non-empty 2-D base, got "
                         f"{tuple(base.shape)}")
    if blocks.dim() != 3 or blocks.shape[1] < 1 or blocks.shape[2] < 1:
        raise ValueError(f"block_scatter wants (K, bh, bw) blocks, got "
                         f"{tuple(blocks.shape)}")
    if ids.numel() != blocks.shape[0]:
        raise ValueError(f"{ids.numel()} ids for {blocks.shape[0]} blocks")
    if inplace and not base.is_contiguous():
        raise ValueError("block_scatter in place needs a contiguous base")
    m, n = base.shape
    _, bh, bw = blocks.shape
    return m, n, bh, bw, -(-m // bh), -(-n // bw)


def plain(base: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor, *,
          inplace: bool = False) -> torch.Tensor:
    """The scatter in plain PyTorch."""
    m, n, bh, bw, gh, gw = _check(base, ids, blocks, inplace)
    dtype = base.dtype
    work = _SIGNED.get(dtype, dtype)  # index_put_ lacks unsigned 16/32/64
    padded = torch.zeros((gh * bh, gw * bw), dtype=work, device=base.device)
    padded[:m, :n] = base.view(work)
    grid = padded.view(gh, bh, gw, bw).permute(0, 2, 1, 3)  # (gh, gw, bh, bw)
    n_blocks = gh * gw
    ids = ids.reshape(-1).to(device=base.device, dtype=torch.int64)
    ids = torch.where(ids < 0, ids + n_blocks, ids)
    keep = (ids >= 0) & (ids < n_blocks)
    ids = ids[keep]
    tiles = blocks.to(device=base.device, dtype=dtype).view(work)[keep]
    grid[ids // gw, ids % gw] = tiles
    out = padded[:m, :n].view(dtype)
    if inplace:
        return base.copy_(out)
    return out.contiguous()


def launch(base: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor, *,
           inplace: bool = False) -> torch.Tensor:
    """The scatter over CUDA tensor ``base``, by the kernel."""
    global launches
    if not base.is_cuda:
        raise ValueError(f"block_scatter kernel needs a CUDA tensor, got "
                         f"{base.device}")
    m, n, bh, bw, _, _ = _check(base, ids, blocks, inplace)
    src = base.contiguous()
    out = src if inplace else torch.empty_like(src)
    blocks = blocks.to(device=base.device, dtype=base.dtype).contiguous()
    ids = ids.to(device=base.device, dtype=torch.int32).contiguous().reshape(-1)
    k = ids.numel()
    eb = base.element_size()
    w = _word_bytes(src.data_ptr(), out.data_ptr(), blocks.data_ptr(),
                    n * eb, bw * eb)
    fn = _build.function("block_scatter", "rt_block_scatter",
                         [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 5
                         + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream(base.device).cuda_stream
        err = fn(src.data_ptr(), out.data_ptr(), ids.data_ptr(),
                 blocks.data_ptr(), m, n * eb // w, bh, bw * eb // w, k, w,
                 int(not inplace), stream)
    _build.check(err, "block_scatter launch")
    with _count_lock:
        launches += 1
    return out
