"""Entry points of the port's kernels, dispatched on the operand's device.

A CUDA tensor launches the hand-written kernel (and raises if it cannot be
built or launched); a CPU tensor runs the kernel module's plain PyTorch
version. There is no other route and nothing falls back. ``block_topk`` is
glue over two kernels: ``block_norms``, a stable sort of the norms in
PyTorch (as the reference's ``jax.lax.top_k`` is outside Pallas), then
``block_gather``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import obs
from . import adamw as _adamw
from . import block_gather as _gather
from . import block_norms as _norms
from . import block_scatter as _bscatter
from . import coo_scatter as _scatter
from . import unshuffle as _unshuffle


def _route(t: torch.Tensor, mod) -> Any:
    if t.device.type == "cuda":
        return mod.launch
    if t.device.type == "cpu":
        return mod.plain
    raise ValueError(f"no kernel route for device {t.device}")


def adamw(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
          scale: torch.Tensor, lr: torch.Tensor, b1c: torch.Tensor,
          b2c: torch.Tensor, *, b1: float, b2: float, eps: float,
          weight_decay: float) -> None:
    """One AdamW step of leaf ``p`` and its f32 moments, in place (see
    :mod:`.adamw`)."""
    _route(p, _adamw)(g, p, m, v, scale, lr, b1c, b2c, b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay)


def block_gather(x: torch.Tensor, ids: torch.Tensor,
                 block_shape: Tuple[int, int]) -> torch.Tensor:
    """(K, bh, bw) tiles of 2-D ``x`` at row-major grid ``ids``."""
    return _route(x, _gather)(x, ids, block_shape)


def block_norms(x: torch.Tensor, block_shape: Tuple[int, int]) -> torch.Tensor:
    """``(gh * gw,)`` f32 sums of squares of the (bh, bw) tiles of 2-D ``x``."""
    return _route(x, _norms)(x, block_shape)


def block_scatter(base: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor,
                  *, inplace: bool = False) -> torch.Tensor:
    """``base`` with (K, bh, bw) ``blocks`` written at grid ``ids`` (see
    :mod:`.block_scatter`; ``inplace=True`` writes into ``base``)."""
    return _route(base, _bscatter)(base, ids, blocks, inplace=inplace)


def block_topk(x: torch.Tensor, block_shape: Tuple[int, int],
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, blocks) of the ``k`` highest-energy tiles of 2-D ``x``.

    ``block_norms``, then the top ``k``, then ``block_gather``. Ids are int32
    in order of falling norm; equal norms take the lower id first, as
    ``jax.lax.top_k`` orders them (a stable descending sort: ``torch.topk``
    gives no such order on CUDA).
    """
    ids = topk_ids(block_norms(x, block_shape), k)
    return ids, block_gather(x, ids, block_shape)


def topk_ids(norms: torch.Tensor, k: int) -> torch.Tensor:
    """Int32 ids of the ``k`` largest of 1-D ``norms``, largest first; equal
    norms take the lower id first (``jax.lax.top_k``'s order)."""
    k = int(k)
    if not 0 <= k <= norms.numel():
        raise ValueError(f"k={k} outside [0, {norms.numel()}]")
    with obs.span("compress.select"):
        order = torch.sort(norms, descending=True, stable=True).indices[:k]
        return order.to(torch.int32)


def coo_scatter(flat_idx: torch.Tensor, values: torch.Tensor, size: int, *,
                unique: bool = False) -> torch.Tensor:
    """Dense flat ``(size,)`` buffer from COO pairs (see :mod:`.coo_scatter`)."""
    return _route(values, _scatter)(flat_idx, values, size, unique=unique)


def unshuffle(planes: torch.Tensor) -> torch.Tensor:
    """Byte-plane transpose: (itemsize, n) uint8 planes -> (n, itemsize)."""
    return _route(planes, _unshuffle)(planes)


def unshuffle_host(planes: np.ndarray, *, device: Any = "cuda",
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """The frame-decode hook (``lake.compression.set_unshuffle_kernel``):
    numpy ``(itemsize, n)`` planes in, the ``(n, itemsize)`` items out,
    transposed on ``device``. With ``out`` (a writable ``(n, itemsize)``
    uint8 array) the items land there and ``out`` is returned; without it,
    in a new array.

    On a card the planes go up in one transfer straight from their pageable
    buffer (read-only, as decoded), the register variant transposes a frame
    of any length, and the items come down in one transfer straight into
    ``out``. On an H100 host both transfers beat staging through pinned
    memory (``PERF.md``). The copy down is synchronous, so decode-pool
    threads may call this concurrently.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"unshuffle hook bound to {dev}, but "
                           f"torch.cuda.is_available() is false")
    itemsize, n = planes.shape
    if out is None:
        out = np.empty((n, itemsize), dtype=np.uint8)
    elif (out.shape != (n, itemsize) or out.dtype != np.uint8
          or not out.flags.writeable):
        raise ValueError(f"unshuffle_host wants a writable ({n}, {itemsize}) "
                         f"uint8 out, got {out.shape} {out.dtype}")
    rows = torch.empty((itemsize, n), dtype=torch.uint8, device=dev)
    if dev.type == "cuda":
        _unshuffle.upload_planes(planes, rows)
    else:
        rows.numpy()[...] = planes  # torch wraps no read-only array
    torch.from_numpy(out).copy_(unshuffle(rows))
    return out
