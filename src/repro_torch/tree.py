"""Trees of tensors: flattening, leaf names, and the crossing to numpy.

Parameter, gradient, residual and train-state trees are nested dicts,
lists, tuples and NamedTuples of tensors. Dict keys are visited in sorted
order and a NamedTuple's fields in their declared order, as
``jax.tree_util`` flattens them, and a leaf's name joins its path with
``/`` (``blocks/attn/wq``, ``layers/0``, ``opt/m/embed``), as the
reference's ``_path_str`` (``repro.dist.sharding``) names it: a list or
tuple position by its index, a NamedTuple field by its name. The names are
the tensor ids under a ``ModelRepo`` prefix and a checkpoint's manifest
keys, so weights and checkpoints written by either package load in the
other.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from .core.encodings.base import BF16_STAGING, ml_dtypes
from .lake.device import to_torch


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def leaves(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs of ``tree`` in flattening order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [tree[key] for key in keys]
    elif _is_namedtuple(tree):
        keys, subs = tree._fields, tree
    elif isinstance(tree, (list, tuple)):
        keys, subs = range(len(tree)), tree
    else:
        return [(path, tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in zip(keys, subs):
        out += leaves(sub, f"{path}/{key}" if path else str(key))
    return out


def rebuild(tree: Any, new_leaves) -> Any:
    """``tree``'s structure, NamedTuple types included, with its leaves
    taken, in order, from the iterator ``new_leaves``."""
    if isinstance(tree, dict):
        return {key: rebuild(tree[key], new_leaves) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [rebuild(sub, new_leaves) for sub in tree]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if _is_namedtuple(tree) else tuple(items)
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
