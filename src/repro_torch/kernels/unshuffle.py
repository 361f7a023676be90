"""unshuffle: the byte-plane transpose of frame decode.

``(itemsize, n)`` uint8 planes in, ``(n, itemsize)`` items out. ``launch``
runs the CUDA kernel of ``csrc/unshuffle.cu`` (the port of the Pallas
kernel ``repro/kernels/unshuffle.py``); ``plain`` is the same function in
plain PyTorch, which the CPU path runs and the card checks the kernel
against.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

launches = 0  # kernel launches since the last reset (set to 0 to reset)
_count_lock = threading.Lock()
MAX_ITEMSIZE = 32  # the kernel's shared-memory tile holds at most 32 planes


def _check(planes: torch.Tensor) -> None:
    if planes.dim() != 2 or planes.dtype != torch.uint8:
        raise ValueError(f"unshuffle wants (itemsize, n) uint8 planes, got "
                         f"{tuple(planes.shape)} {planes.dtype}")


def plain(planes: torch.Tensor) -> torch.Tensor:
    """The transpose in plain PyTorch: one strided copy per plane."""
    _check(planes)
    itemsize, n = planes.shape
    out = torch.empty((n, itemsize), dtype=torch.uint8, device=planes.device)
    for p in range(itemsize):
        out[:, p] = planes[p]
    return out


def launch(planes: torch.Tensor) -> torch.Tensor:
    """The transpose of CUDA ``planes``, by the kernel."""
    global launches
    _check(planes)
    if not planes.is_cuda:
        raise ValueError(f"unshuffle kernel needs a CUDA tensor, got {planes.device}")
    itemsize, n = planes.shape
    if not 1 <= itemsize <= MAX_ITEMSIZE:
        raise ValueError(f"unshuffle kernel takes itemsize 1..{MAX_ITEMSIZE}, "
                         f"got {itemsize}")
    planes = planes.contiguous()
    out = torch.empty((n, itemsize), dtype=torch.uint8, device=planes.device)
    fn = _build.function("unshuffle", "rt_unshuffle",
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = fn(planes.data_ptr(), out.data_ptr(), n, itemsize, stream)
    _build.check(err, "unshuffle launch")
    with _count_lock:
        launches += 1
    return out
