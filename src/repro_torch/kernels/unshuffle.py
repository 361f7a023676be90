"""unshuffle: the byte-plane transpose of frame decode.

``(itemsize, n)`` uint8 planes in, ``(n, itemsize)`` items out. ``launch``
runs the CUDA kernel of ``csrc/unshuffle.cu`` (the port of the Pallas
kernel ``repro/kernels/unshuffle.py``); ``plain`` is the same function in
plain PyTorch, which the CPU path runs and the card checks the kernel
against. :func:`variant` picks the kernel's variant from the shapes and
pointers before the launch.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _build

launches = 0  # kernel launches since the last reset (set to 0 to reset)
# launches per variant since the caller last emptied it
variant_launches = {"register": 0, "shared": 0}
_count_lock = threading.Lock()
MAX_ITEMSIZE = 32  # the shared variant's tile holds at most 32 planes
REGISTER_ITEMSIZES = (2, 4, 8, 16)
_VARIANT_CODE = {"shared": 0, "register": 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]
_UPLOAD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_void_p]


def _check(planes: torch.Tensor) -> None:
    if planes.dim() != 2 or planes.dtype != torch.uint8:
        raise ValueError(f"unshuffle wants (itemsize, n) uint8 planes, got "
                         f"{tuple(planes.shape)} {planes.dtype}")


def variant(itemsize: int, out_ptr: int) -> str:
    """The kernel variant for items of ``itemsize`` bytes written at
    ``out_ptr``: ``"register"`` (the register byte transpose: itemsize 2,
    4, 8 or 16 and ``out`` 16-byte aligned; any n, planes at any
    alignment) or ``"shared"`` (the shared-memory tiles: every other
    itemsize up to 32)."""
    if not 1 <= itemsize <= MAX_ITEMSIZE:
        raise ValueError(f"unshuffle kernel takes itemsize 1..{MAX_ITEMSIZE}, "
                         f"got {itemsize}")
    if itemsize in REGISTER_ITEMSIZES and out_ptr % 16 == 0:
        return "register"
    return "shared"


def plain(planes: torch.Tensor) -> torch.Tensor:
    """The transpose in plain PyTorch: one strided copy per plane."""
    _check(planes)
    itemsize, n = planes.shape
    out = torch.empty((n, itemsize), dtype=torch.uint8, device=planes.device)
    for p in range(itemsize):
        out[:, p] = planes[p]
    return out


def upload_planes(planes: np.ndarray, rows: torch.Tensor) -> None:
    """Copy host ``(itemsize, n)`` uint8 ``planes`` into the contiguous CUDA
    tensor ``rows`` of the same shape, in one transfer on the current
    stream, straight from the planes' (pageable) buffer, which may be
    read-only. It is no kernel launch and counts none."""
    if (not rows.is_cuda or rows.dtype != torch.uint8
            or tuple(rows.shape) != planes.shape or not rows.is_contiguous()):
        raise ValueError(f"upload_planes wants contiguous CUDA {planes.shape} "
                         f"uint8 rows, got {tuple(rows.shape)} {rows.dtype} "
                         f"on {rows.device}")
    planes = np.ascontiguousarray(planes, dtype=np.uint8)
    fn = _build.function("unshuffle", "rt_upload_planes", _UPLOAD_ARGTYPES)
    with _build.device_scope(rows):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(), planes.ctypes.data, planes.nbytes, stream)
    _build.check(err, "unshuffle plane upload")


def launch(planes: torch.Tensor) -> torch.Tensor:
    """The transpose of CUDA ``planes``, by the kernel."""
    global launches
    _check(planes)
    if not planes.is_cuda:
        raise ValueError(f"unshuffle kernel needs a CUDA tensor, got {planes.device}")
    itemsize, n = planes.shape
    planes = planes.contiguous()
    out = torch.empty((n, itemsize), dtype=torch.uint8, device=planes.device)
    which = variant(itemsize, out.data_ptr())
    fn = _build.function("unshuffle", "rt_unshuffle", _ARGTYPES)
    with _build.device_scope(planes):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = fn(planes.data_ptr(), out.data_ptr(), n, itemsize,
                 _VARIANT_CODE[which], stream)
    _build.check(err, f"unshuffle launch ({which})")
    with _count_lock:
        launches += 1
        variant_launches[which] += 1
    return out
