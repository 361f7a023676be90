"""The least bytes each compressor kernel must move, from its operands'
shapes: every input byte read once, every output byte written once.

``valid`` counts the elements of the tiles at ``ids`` that lie inside the
(m, n) operand; a tile on its ragged edge holds fewer."""

from __future__ import annotations

from typing import Sequence


def tile_elements(m: int, n: int, bh: int, bw: int,
                  ids: Sequence[int]) -> int:
    """Elements inside (m, n) of the row-major grid tiles ``ids``."""
    gw = -(-n // bw)
    total = 0
    for i in ids:
        gi, gj = divmod(int(i), gw)
        total += max(0, min(bh, m - gi * bh)) * max(0, min(bw, n - gj * bw))
    return total


def block_norms(m: int, n: int, bh: int, bw: int, itemsize: int) -> int:
    """Read the (m, n) operand, write one f32 per tile."""
    return m * n * itemsize + (-(-m // bh)) * (-(-n // bw)) * 4


def block_gather(m: int, n: int, bh: int, bw: int, itemsize: int,
                 ids: Sequence[int]) -> int:
    """Read the ids and the tiles' elements inside the operand; write k
    whole (bh, bw) tiles."""
    k = len(ids)
    return 4 * k + tile_elements(m, n, bh, bw, ids) * itemsize \
        + k * bh * bw * itemsize


def block_scatter(m: int, n: int, bh: int, bw: int, itemsize: int,
                  ids: Sequence[int], inplace: bool) -> int:
    """Read the ids and k whole tiles, write their elements inside the
    base; a copy that is not in place also reads and writes the base."""
    k = len(ids)
    moved = 4 * k + k * bh * bw * itemsize \
        + tile_elements(m, n, bh, bw, ids) * itemsize
    return moved if inplace else moved + 2 * m * n * itemsize
