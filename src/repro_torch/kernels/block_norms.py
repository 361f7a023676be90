"""block_norms: the squared L2 norm of every (bh, bw) tile of a 2-D operand.

``launch`` runs the CUDA kernel of ``csrc/block_norms.cu`` (the port of the
Pallas kernel ``repro/kernels/block_norms.py``); ``plain`` is the same
function in plain PyTorch, which the CPU path runs and the card checks the
kernel against. The result is ``(gh * gw,)`` f32 in row-major grid order;
each element is cast to f32 before it is squared, and a ragged edge reads
as zeros. The Pallas kernel's ``(G, B)`` blocked view is the case
``block_shape = (1, B)``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from . import _build

launches = 0  # kernel launches since the last reset (set to 0 to reset)
_count_lock = threading.Lock()
# element kinds of csrc/block_norms.cu, in its order
KINDS = (torch.float32, torch.float64, torch.float16, torch.bfloat16)


def _grid(x: torch.Tensor, block_shape: Tuple[int, int]):
    bh, bw = (int(b) for b in block_shape)
    if x.dim() != 2 or bh < 1 or bw < 1 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"block_norms wants a non-empty 2-D x and positive "
                         f"tiles, got {tuple(x.shape)} and {block_shape}")
    m, n = x.shape
    return m, n, bh, bw, -(-m // bh), -(-n // bw)


def plain(x: torch.Tensor, block_shape: Tuple[int, int]) -> torch.Tensor:
    """Per-tile sums of squares of ``x`` in f32, in plain PyTorch."""
    m, n, bh, bw, gh, gw = _grid(x, block_shape)
    xf = x.to(torch.float32)
    if (gh * bh, gw * bw) != (m, n):
        xp = torch.zeros((gh * bh, gw * bw), dtype=torch.float32,
                         device=x.device)
        xp[:m, :n] = xf
        xf = xp
    return xf.reshape(gh, bh, gw, bw).square().sum(dim=(1, 3)).reshape(-1)


def launch(x: torch.Tensor, block_shape: Tuple[int, int]) -> torch.Tensor:
    """Per-tile sums of squares of CUDA tensor ``x``, by the kernel."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"block_norms kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in KINDS:
        raise TypeError(f"block_norms kernel has no {x.dtype} path")
    m, n, bh, bw, gh, gw = _grid(x, block_shape)
    x = x.contiguous()
    out = torch.empty(gh * gw, dtype=torch.float32, device=x.device)
    wide = 16 // x.element_size()
    vec = wide if (x.data_ptr() % 16 == 0 and n % wide == 0
                   and bw % wide == 0) else 1
    fn = _build.function("block_norms", "rt_block_norms",
                         [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4
                         + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), m, n, bh, bw,
                 KINDS.index(x.dtype), vec, stream)
    _build.check(err, "block_norms launch")
    with _count_lock:
        launches += 1
    return out
