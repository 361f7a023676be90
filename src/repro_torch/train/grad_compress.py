"""Cross-pod gradient compression — the paper's BSGS applied to the wire.

The port of ``repro.train.grad_compress``. Top-k block sparsification with
error feedback keeps only the high-energy blocks of each pod's gradient,
plus their coordinates:

  e_p   = g_p + r_p                  (per-pod gradient + residual, in f32)
  ids,B = block_topk(e_p, k)         (BSGS encode: kernels block_norms,
                                      then the top k, then block_gather)
  r_p'  = e_p - decode(ids, B)       (error feedback; decode is the
                                      block_scatter kernel)
  g_hat = mean_p decode_p            (mean of the compressed payloads)

Gradient trees are nested dicts, lists and tuples of tensors whose leaves
carry a leading ``pod`` dimension; dict keys are visited in sorted order, as
``jax.tree`` flattens them. The pods are a loop over that dimension: each
pod's leaf is a contiguous 2-D view ``(rows, last dim)``, and the kernels
mask its ragged edge, so no padded copy is made (the reference pads with
``jnp.pad``; the bytes are the same).

This is the single-process form (the reference's ``replicate_spec=None``):
every pod lives in this process, so the decode of all pods' payloads is the
decode of each pod's own, done once. The exchange of ``(ids, blocks)``
across processes is not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..lake.device import to_torch

DEFAULT_BLOCK = (8, 128)


class CompressState(NamedTuple):
    """Error-feedback state: residuals shaped like the grads (pod dim first)."""

    residual: Any


# -- small pytree helpers (dicts in sorted key order, lists, tuples) ----------

def _leaves(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of ``tree``; paths join keys with ``/``."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for key in sorted(tree):
            out += _leaves(tree[key], f"{path}/{key}" if path else str(key))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += _leaves(sub, f"{path}/{i}" if path else str(i))
        return out
    return [(path, tree)]


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves taken, in order, from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [_rebuild(sub, leaves) for sub in tree]
        return items if isinstance(tree, list) else tuple(items)
    return next(leaves)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf."""
    return _rebuild(tree, iter([fn(leaf) for _, leaf in _leaves(tree)]))


# -- compression ---------------------------------------------------------------

def _leaf_geometry(shape, block=DEFAULT_BLOCK):
    rows = 1 if len(shape) <= 1 else int(math.prod(shape[:-1]))
    cols = shape[-1] if shape else 1
    bh = min(block[0], rows)
    bw = min(block[1], cols)
    gh = -(-rows // bh)
    gw = -(-cols // bw)
    return (rows, cols), (bh, bw), (gh * bh, gw * bw), gh * gw


def _compress_leaf(e: torch.Tensor, ratio: float, block=DEFAULT_BLOCK):
    """e: (pods, ...) f32 -> (ids (pods, k) int32, blocks (pods, k, bh, bw),
    the leaf's 2-D shape, the tile shape): each pod's top-k tiles."""
    x2_shape, bs, _, n_blocks = _leaf_geometry(tuple(e.shape[1:]), block)
    k = max(1, int(n_blocks * ratio))
    ev = e.reshape(e.shape[0], *x2_shape)
    picks = [ops.block_topk(ev[p], bs, k) for p in range(e.shape[0])]
    ids = torch.stack([i for i, _ in picks])
    blocks = torch.stack([b for _, b in picks])
    return ids, blocks, x2_shape, bs


def compressed_grad_mean(grads_podwise: Any, residuals: Any, *,
                         ratio: float = 0.05, block=DEFAULT_BLOCK,
                         with_payload: bool = False
                         ) -> Tuple[Any, Any, Dict[str, Any]]:
    """grads_podwise: tree of tensors, each leaf ``(n_pods, ...)``.

    Returns ``(mean_decoded_grads (no pod dim, f32), new_residuals (f32,
    pod dim first), stats)``. ``stats`` counts ``sent_bytes`` (the payload:
    int32 ids and f32 blocks of every pod) and ``dense_bytes`` (the f32
    gradients) as the reference does. ``with_payload=True`` also returns
    that payload, ``stats["payload"] = {leaf path: (ids (pods, k), blocks
    (pods, k, bh, bw))}``, what a cross-process exchange would send;
    otherwise each leaf's payload is freed once it is decoded.

    Each leaf's ``e = g + r`` is a new f32 tensor, and the new residual is
    computed in place in it; the decode scatters in place into a zero
    buffer. The inputs are not modified.
    """
    stats: Dict[str, Any] = {"sent_bytes": 0, "dense_bytes": 0}
    payload = {}
    g_leaves = _leaves(grads_podwise)
    r_leaves = _leaves(residuals)
    if [p for p, _ in g_leaves] != [p for p, _ in r_leaves]:
        raise ValueError("residuals do not have the structure of the grads")
    means, new_rs = [], []
    for (path, g), (_, r) in zip(g_leaves, r_leaves):
        e = g.to(torch.float32) + r
        pods = e.shape[0]
        ids, blocks, x2_shape, _ = _compress_leaf(e, ratio, block)
        decoded = torch.zeros((pods,) + x2_shape, dtype=torch.float32,
                              device=e.device)
        for p in range(pods):
            ops.block_scatter(decoded[p], ids[p], blocks[p], inplace=True)
        means.append(decoded.sum(dim=0).div_(pods).reshape(g.shape[1:]))
        ev = e.view((pods,) + x2_shape)
        ev.sub_(decoded)
        new_rs.append(e)
        stats["sent_bytes"] += int(ids.numel() * 4 + blocks.numel() * 4)
        stats["dense_bytes"] += int(e.numel() * 4)
        if with_payload:
            payload[path] = (ids, blocks)
        del decoded, ids, blocks
    if with_payload:
        stats["payload"] = payload
    return (_rebuild(grads_podwise, iter(means)),
            _rebuild(grads_podwise, iter(new_rs)), stats)


def init_residuals(grads_podwise: Any) -> Any:
    """Zero f32 residuals shaped like the grads, on each grad's device."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_podwise)


def residuals_from_numpy(tree: Any, device: Any = "cuda") -> Any:
    """The reference's residual tree (its leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, residuals)``) as the port's: f32 tensors on
    ``device`` with the same bytes, so a run resumes its error feedback."""
    return tree_map(lambda a: to_torch(np.asarray(a, dtype=np.float32),
                                       device), tree)


def compression_ratio_bytes(stats: Dict[str, int]) -> float:
    """Bytes sent / dense f32 bytes."""
    return stats["sent_bytes"] / max(stats["dense_bytes"], 1)
