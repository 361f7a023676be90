"""Frozen arithmetic of the BSGS payload: the bytes one pod's compressed
gradient puts on the wire (int32 block ids and f32 blocks) over the dense
f32 bytes of its gradient, from the leaves' shapes alone.

Each leaf is viewed as 2-D (its leading dims flattened, its last dim
kept) and cut into (bh, bw) tiles, each no larger than the leaf; a pod
sends k = max(1, floor(tiles x ratio)) of them."""

from __future__ import annotations

import math
from typing import Iterable, Sequence, Tuple


def leaf_geometry(shape: Sequence[int], block: Tuple[int, int]):
    """((rows, cols), (bh, bw), (gh, gw)) of a leaf of ``shape``."""
    shape = tuple(int(s) for s in shape)
    rows = 1 if len(shape) <= 1 else math.prod(shape[:-1])
    cols = shape[-1] if shape else 1
    bh, bw = min(block[0], rows), min(block[1], cols)
    return (rows, cols), (bh, bw), (-(-rows // bh), -(-cols // bw))


def blocks_sent(shape: Sequence[int], ratio: float,
                block: Tuple[int, int]) -> int:
    """k of one leaf: the tiles a pod sends."""
    _, _, (gh, gw) = leaf_geometry(shape, block)
    return max(1, int(gh * gw * ratio))


def payload_bytes(k: int, block: Tuple[int, int]) -> int:
    """Bytes of ``k`` sent tiles of ``block`` (each tile's int32 id and its
    f32 elements)."""
    return 4 * k + 4 * k * block[0] * block[1]


def dense_bytes(shape: Sequence[int]) -> int:
    """Bytes of a leaf's dense f32 gradient."""
    return 4 * math.prod(int(s) for s in shape)


def wire_bytes(shapes: Iterable[Sequence[int]], ratio: float,
               block: Tuple[int, int]) -> Tuple[int, int]:
    """(payload bytes, dense f32 bytes) of one pod's gradient."""
    sent = dense = 0
    for shape in shapes:
        _, bs, _ = leaf_geometry(shape, block)
        sent += payload_bytes(blocks_sent(shape, ratio, block), bs)
        dense += dense_bytes(shape)
    return sent, dense


def wire_ratio(shapes: Iterable[Sequence[int]], ratio: float,
               block: Tuple[int, int]) -> float:
    """Payload bytes over dense f32 bytes."""
    sent, dense = wire_bytes(list(shapes), ratio, block)
    return sent / dense
