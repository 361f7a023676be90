"""Entry points of the port's kernels, dispatched on the operand's device.

A CUDA tensor launches the hand-written kernel (and raises if it cannot be
built or launched); a CPU tensor runs the kernel module's plain PyTorch
version. There is no other route and nothing falls back.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from . import block_gather as _gather
from . import coo_scatter as _scatter
from . import unshuffle as _unshuffle


def _route(t: torch.Tensor, mod) -> Any:
    if t.device.type == "cuda":
        return mod.launch
    if t.device.type == "cpu":
        return mod.plain
    raise ValueError(f"no kernel route for device {t.device}")


def block_gather(x: torch.Tensor, ids: torch.Tensor,
                 block_shape: Tuple[int, int]) -> torch.Tensor:
    """(K, bh, bw) tiles of 2-D ``x`` at row-major grid ``ids``."""
    return _route(x, _gather)(x, ids, block_shape)


def coo_scatter(flat_idx: torch.Tensor, values: torch.Tensor, size: int, *,
                unique: bool = False) -> torch.Tensor:
    """Dense flat ``(size,)`` buffer from COO pairs (see :mod:`.coo_scatter`)."""
    return _route(values, _scatter)(flat_idx, values, size, unique=unique)


def unshuffle(planes: torch.Tensor) -> torch.Tensor:
    """Byte-plane transpose: (itemsize, n) uint8 planes -> (n, itemsize)."""
    return _route(planes, _unshuffle)(planes)


def unshuffle_host(planes: np.ndarray, *, device: Any = "cuda") -> np.ndarray:
    """The frame-decode hook (``lake.compression.set_unshuffle_kernel``):
    numpy ``(itemsize, n)`` planes in, numpy ``(n, itemsize)`` items out,
    transposed on ``device``.

    The planes go through pinned memory to the card and back; the only
    synchronisation is the copy back, so decode-pool threads may call this
    concurrently.
    """
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    src = torch.empty(planes.shape, dtype=torch.uint8, pin_memory=cuda)
    src.numpy()[...] = planes
    out = unshuffle(src.to(dev, non_blocking=True))
    if not cuda:
        return out.numpy()
    host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(out)
    return host.numpy()
