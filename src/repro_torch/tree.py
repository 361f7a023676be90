"""Trees of tensors: flattening, leaf names, and the crossing to numpy.

Parameter, gradient and residual trees are nested dicts, lists and tuples
of tensors. Dict keys are visited in sorted order, as ``jax.tree_util``
flattens a dict, and a leaf's name joins its path with ``/``
(``blocks/attn/wq``, ``layers/0``), as the reference's ``_path_str``
(``repro.dist.sharding``) names it. The names are the tensor ids under a
``ModelRepo`` prefix, so weights written by either package load in the
other.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from .core.encodings.base import BF16_STAGING, ml_dtypes
from .lake.device import to_torch


def leaves(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs of ``tree`` in flattening order."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for key in sorted(tree):
            out += leaves(tree[key], f"{path}/{key}" if path else str(key))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += leaves(sub, f"{path}/{i}" if path else str(i))
        return out
    return [(path, tree)]


def rebuild(tree: Any, new_leaves) -> Any:
    """``tree``'s structure with its leaves taken, in order, from the
    iterator ``new_leaves``."""
    if isinstance(tree, dict):
        return {key: rebuild(tree[key], new_leaves) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [rebuild(sub, new_leaves) for sub in tree]
        return items if isinstance(tree, list) else tuple(items)
    return next(new_leaves)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf."""
    return rebuild(tree, iter([fn(leaf) for _, leaf in leaves(tree)]))


def to_numpy(t: Any) -> np.ndarray:
    """A tensor (on any device) as a host numpy array with its bytes, the
    inverse of :func:`repro_torch.lake.device.to_torch`: bfloat16 comes
    back as ``ml_dtypes.bfloat16`` where it is installed, else as
    ``BF16_STAGING``. Anything not a tensor goes through ``np.asarray``."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bf16 = BF16_STAGING if ml_dtypes is None else np.dtype(ml_dtypes.bfloat16)
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()


def params_from_numpy(tree: Any, device: Any = "cuda") -> Any:
    """A tree of numpy arrays (the reference's params through
    ``jax.tree.map(np.asarray, params)``: bfloat16 as ``ml_dtypes`` or the
    port's ``BF16_STAGING``) as torch tensors on ``device``, same bytes."""
    return tree_map(lambda a: to_torch(np.asarray(a), device), tree)


def params_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`params_from_numpy`: host numpy arrays with the
    tensors' bytes (bfloat16 as ``ml_dtypes.bfloat16`` where it is
    installed, else as ``BF16_STAGING``)."""
    return tree_map(to_numpy, tree)
