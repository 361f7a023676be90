"""Device-side tensor encodings with a fixed capacity, in PyTorch.

The port of ``repro.core.device``. The device variants of the paper's
codecs carry a fixed ``capacity`` plus a live count, as the reference's
static-shape jnp versions do, so the two packages give the same arrays.
The COO codecs, ``blockify``/``unblockify`` and ``bsgs_encode`` are plain
PyTorch on the operand's device, as the reference is plain jnp. Block top-k
and the block decode of a 2-D tensor with 2-D tiles go through the port's
kernels (``ops.block_topk``, ``ops.block_scatter``), as the gradient
compressor (:mod:`repro_torch.train.grad_compress`) does; their N-D cases,
which no kernel covers, stay plain PyTorch.

Block top-k breaks ties as ``jax.lax.top_k`` does: equal norms take the
lower block id first. Where the reference maps a function over a leading
axis with ``vmap``, callers here pass a batch dimension or loop.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops


class DeviceCOO(NamedTuple):
    """Fixed-capacity on-device COO carrier (padding = index == size)."""

    flat_indices: torch.Tensor  # (capacity,) int32/int64; == size => padding
    values: torch.Tensor        # (capacity,)
    nnz: torch.Tensor           # () int32, clamped to capacity


class DeviceBlocks(NamedTuple):
    """Fixed-capacity on-device block-sparse carrier (BSGS)."""

    block_ids: torch.Tensor     # (capacity,) flat block-grid ids; == n_blocks => pad
    blocks: torch.Tensor        # (capacity, block_elems)
    count: torch.Tensor         # () int32


def _flatnonzero(mask: torch.Tensor, capacity: int, fill: int) -> torch.Tensor:
    """The first ``capacity`` indices where ``mask`` holds, ascending, padded
    with ``fill`` (``jnp.flatnonzero(size=, fill_value=)``)."""
    hits = torch.nonzero(mask.reshape(-1)).reshape(-1)[:capacity]
    out = torch.full((capacity,), fill, dtype=torch.int64, device=mask.device)
    out[:hits.numel()] = hits
    return out


def _drop_index(idx: torch.Tensor, size: int):
    """(wrapped indices, keep mask) for a scatter with JAX's ``mode="drop"``:
    ``[-size, 0)`` counts from the end, anything else outside drops."""
    idx = idx.reshape(-1).to(torch.int64)
    idx = torch.where(idx < 0, idx + size, idx)
    return idx, (idx >= 0) & (idx < size)


# ---------------------------------------------------------------------------
# COO
# ---------------------------------------------------------------------------


def coo_encode(x: torch.Tensor, capacity: int) -> DeviceCOO:
    """Dense -> fixed-capacity COO (extra non-zeros are truncated)."""
    flat = x.reshape(-1)
    size = flat.numel()
    nonzero = flat != 0
    idx = _flatnonzero(nonzero, capacity, size)
    vals = torch.where(idx < size, flat[idx.clamp(0, max(size - 1, 0))],
                       torch.zeros((), dtype=x.dtype, device=x.device))
    nnz = torch.clamp(nonzero.sum(), max=capacity).to(torch.int32)
    return DeviceCOO(idx.to(torch.int32) if size < 2**31 else idx, vals, nnz)


def coo_decode(coo: DeviceCOO, shape: Tuple[int, ...]) -> torch.Tensor:
    """COO -> dense of ``shape`` (padding entries dropped).

    Each value is stored, not added (the reference's ``.set``), unlike the
    ``coo_scatter`` kernel, which adds duplicates.
    """
    size = math.prod(shape)
    flat = torch.zeros(size, dtype=coo.values.dtype, device=coo.values.device)
    idx, keep = _drop_index(coo.flat_indices.to(flat.device), size)
    flat[idx[keep]] = coo.values[keep]
    return flat.reshape(tuple(shape))


# ---------------------------------------------------------------------------
# blocks: shared reshape helpers
# ---------------------------------------------------------------------------


def _block_view_shape(shape: Sequence[int], bs: Sequence[int]):
    """Interleaved (g0,b0,g1,b1,...) shape + permutation to (g..., b...)."""
    nd = len(shape)
    grid = tuple(-(-s // b) for s, b in zip(shape, bs))
    inter = tuple(v for d in range(nd) for v in (grid[d], bs[d]))
    perm = tuple(2 * d for d in range(nd)) + tuple(2 * d + 1 for d in range(nd))
    return grid, inter, perm


def blockify(x: torch.Tensor, block_shape: Sequence[int]) -> torch.Tensor:
    """(… dense …) -> (n_blocks, block_elems), zero-padding ragged edges."""
    bs = tuple(int(b) for b in block_shape)
    shape = tuple(x.shape)
    grid, inter, perm = _block_view_shape(shape, bs)
    padded = tuple(g * b for g, b in zip(grid, bs))
    if padded != shape:
        xp = torch.zeros(padded, dtype=x.dtype, device=x.device)
        xp[tuple(slice(0, s) for s in shape)] = x
        x = xp
    xv = x.reshape(inter).permute(perm)
    return xv.reshape(math.prod(grid), math.prod(bs))


def unblockify(blocks: torch.Tensor, shape: Sequence[int],
               block_shape: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`blockify`; crops the zero padding back off."""
    bs = tuple(int(b) for b in block_shape)
    shape = tuple(int(s) for s in shape)
    grid, inter, perm = _block_view_shape(shape, bs)
    inv = tuple(int(i) for i in np.argsort(perm))
    xv = blocks.reshape(grid + bs).permute(inv)
    xp = xv.reshape(tuple(g * b for g, b in zip(grid, bs)))
    return xp[tuple(slice(0, s) for s in shape)]


# ---------------------------------------------------------------------------
# BSGS: exact non-zero-block encoding
# ---------------------------------------------------------------------------


def bsgs_encode(x: torch.Tensor, block_shape: Tuple[int, ...],
                capacity: int) -> DeviceBlocks:
    """Keep every non-zero block, up to ``capacity`` (exact encoding)."""
    bv = blockify(x, block_shape)
    n_blocks = bv.shape[0]
    nonzero = (bv != 0).any(dim=1)
    ids = _flatnonzero(nonzero, capacity, n_blocks)
    gathered = bv[ids.clamp(0, n_blocks - 1)]
    gathered = torch.where((ids < n_blocks)[:, None], gathered,
                           torch.zeros((), dtype=bv.dtype, device=bv.device))
    count = torch.clamp(nonzero.sum(), max=capacity).to(torch.int32)
    return DeviceBlocks(ids.to(torch.int32), gathered, count)


def bsgs_decode(db: DeviceBlocks, shape: Tuple[int, ...],
                block_shape: Tuple[int, ...]) -> torch.Tensor:
    """Scatter kept blocks back into a dense tensor of ``shape``."""
    if len(shape) == 2 and len(block_shape) == 2:
        out = torch.zeros(tuple(shape), dtype=db.blocks.dtype,
                          device=db.blocks.device)
        tiles = db.blocks.reshape(db.blocks.shape[0], *block_shape)
        return ops.block_scatter(out, db.block_ids, tiles, inplace=True)
    grid, _, _ = _block_view_shape(shape, block_shape)
    n_blocks = math.prod(grid)
    bv = torch.zeros((n_blocks, db.blocks.shape[1]), dtype=db.blocks.dtype,
                     device=db.blocks.device)
    idx, keep = _drop_index(db.block_ids.to(bv.device), n_blocks)
    bv[idx[keep]] = db.blocks[keep]
    return unblockify(bv, shape, block_shape)


# ---------------------------------------------------------------------------
# block top-k (gradient compression): keep the k highest-energy blocks
# ---------------------------------------------------------------------------


def bsgs_topk(x: torch.Tensor, block_shape: Tuple[int, ...],
              k: int) -> DeviceBlocks:
    """Lossy top-k: keep the k highest-energy blocks (grad compression)."""
    count = torch.tensor(int(k), dtype=torch.int32, device=x.device)
    if x.dim() == 2 and len(block_shape) == 2:
        ids, tiles = ops.block_topk(x, block_shape, k)
        return DeviceBlocks(ids, tiles.reshape(k, math.prod(block_shape)), count)
    bv = blockify(x, block_shape)
    ids = ops.topk_ids(bv.to(torch.float32).square().sum(dim=1), k)
    return DeviceBlocks(ids, bv[ids.to(torch.int64)], count)


def compression_ratio(db: DeviceBlocks, shape: Sequence[int]) -> float:
    """Bytes kept / dense bytes — the paper's Cr, device-side."""
    itemsize = db.blocks.element_size()
    kept = db.blocks.numel() * itemsize + db.block_ids.numel() * 4
    dense = math.prod(shape) * itemsize
    return kept / dense
