"""coo_scatter: a dense flat ``(size,)`` buffer from K (index, value) pairs.

``launch`` runs the CUDA kernel of ``csrc/coo_scatter.cu`` (the port of
the Pallas kernel ``repro/kernels/coo_scatter.py``); ``plain`` is the same
function in plain PyTorch, which the CPU path runs and the card checks the
kernel against. Zeros everywhere else; a negative index counts from the
end; an index outside ``[-size, size)`` drops. Duplicates add (bool: logical
or) unless ``unique=True`` promises there are none, as for stored COO
coordinates, and then each value is stored.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

launches = 0  # kernel launches since the last reset (set to 0 to reset)
_count_lock = threading.Lock()

# element kinds of csrc/coo_scatter.cu, in its enum order
KINDS = (torch.float16, torch.bfloat16, torch.float32, torch.float64,
         torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
         torch.bool, torch.complex64, torch.complex128)
# unsigned widths the kernel adds as the same-width signed type
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def _resolve(flat_idx: torch.Tensor, size: int):
    idx = flat_idx.reshape(-1).to(torch.int64)
    idx = torch.where(idx < 0, idx + size, idx)
    keep = (idx >= 0) & (idx < size)
    return idx, keep


def plain(flat_idx: torch.Tensor, values: torch.Tensor, size: int, *,
          unique: bool = False) -> torch.Tensor:
    """The scatter in plain PyTorch."""
    size = int(size)
    dtype = values.dtype
    vals = values.reshape(-1)
    if dtype in _SIGNED:  # index_put_ has no unsigned 16/32/64-bit kernels
        vals = vals.view(_SIGNED[dtype])
    out = torch.zeros(size, dtype=vals.dtype, device=values.device)
    idx, keep = _resolve(flat_idx.to(values.device), size)
    out.index_put_((idx[keep],), vals[keep], accumulate=not unique)
    return out.view(dtype)


def launch(flat_idx: torch.Tensor, values: torch.Tensor, size: int, *,
           unique: bool = False) -> torch.Tensor:
    """The scatter of CUDA tensors, by the kernel."""
    global launches
    if not values.is_cuda:
        raise ValueError(f"coo_scatter kernel needs CUDA tensors, got {values.device}")
    size = int(size)
    if size < 0:
        raise ValueError(f"negative size {size}")
    dtype = values.dtype
    kind_dtype = _SIGNED.get(dtype, dtype)
    if kind_dtype not in KINDS:
        raise TypeError(f"coo_scatter kernel has no {dtype} path")
    vals = values.reshape(-1).contiguous().view(kind_dtype)
    idx = flat_idx.to(device=values.device, dtype=torch.int64).contiguous().reshape(-1)
    if idx.numel() != vals.numel():
        raise ValueError(f"{idx.numel()} indices for {vals.numel()} values")
    # whole 32-bit words, for the compare-and-swap of 8- and 16-bit adds
    per_word = max(1, 4 // vals.element_size())
    out = torch.empty(-(-size // per_word) * per_word, dtype=kind_dtype,
                      device=values.device)
    fn = _build.function("coo_scatter", "rt_coo_scatter",
                         [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                         + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(idx.data_ptr(), vals.data_ptr(), out.data_ptr(), idx.numel(),
                 size, KINDS.index(kind_dtype), int(bool(unique)), stream)
    _build.check(err, "coo_scatter launch")
    with _count_lock:
        launches += 1
    return out[:size].view(dtype)
