"""The parameter layout of each family and the weights drawn from a seed.

:func:`layout` lists every leaf as the store's tensor id names it (the
port's and the reference package's parameter trees: nested dicts, stacked
layers), with its shape, dtype and initial distribution; the family's
module (:mod:`.families`) makes the list from the leaf helpers here.
:func:`draw` makes every leaf on the card from one ``torch.Generator``
seeded by the run's seed, in a fixed order and in chunks of at most
``CHUNK`` elements, so a second call with the same seed gives the same
bytes: the reference draws its copy of the initial weights again instead
of keeping one.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, NamedTuple, Tuple

import torch

from . import families
from .accounting import mamba2_dims

CHUNK = 1 << 27     # f32 elements drawn at a time (512 MiB)
CONV_K = 4


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str           # "normal", "ones" or "zeros"
    std: float = 0.0


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype(a: dict) -> torch.dtype:
    """The dtype the ``arch`` states for its weights."""
    return _DTYPES[a["dtype"]]


def embed_leaves(a: dict) -> List[Leaf]:
    """The embedding, the final norm and, where the head is not tied to
    the embedding, the head."""
    dt = dtype(a)
    d, v = a["d_model"], a["vocab_size"]
    out = [Leaf("embed", (v, d), dt, "normal", 0.02),
           Leaf("final_norm/scale", (d,), dt, "ones")]
    if not a.get("tie_embeddings"):
        out.append(Leaf("unembed", (d, v), dt, "normal", d ** -0.5))
    return out


def attn_mlp_leaves(prefix: str, lead: Tuple[int, ...], a: dict) -> List[Leaf]:
    """An attention+MLP block's leaves under ``prefix``, each stacked over
    the ``lead`` dims."""
    dt = dtype(a)
    d, hd, f = a["d_model"], a["head_dim"], a["d_ff"]
    hq, hkv = a["n_heads"] * hd, a["n_kv_heads"] * hd
    return [
        Leaf(f"{prefix}/attn/wk", lead + (d, hkv), dt, "normal", d ** -0.5),
        Leaf(f"{prefix}/attn/wo", lead + (hq, d), dt, "normal", hq ** -0.5),
        Leaf(f"{prefix}/attn/wq", lead + (d, hq), dt, "normal", d ** -0.5),
        Leaf(f"{prefix}/attn/wv", lead + (d, hkv), dt, "normal", d ** -0.5),
        Leaf(f"{prefix}/ln1/scale", lead + (d,), dt, "ones"),
        Leaf(f"{prefix}/ln2/scale", lead + (d,), dt, "ones"),
        Leaf(f"{prefix}/mlp/w_down", lead + (f, d), dt, "normal", f ** -0.5),
        Leaf(f"{prefix}/mlp/w_gate", lead + (d, f), dt, "normal", d ** -0.5),
        Leaf(f"{prefix}/mlp/w_up", lead + (d, f), dt, "normal", d ** -0.5),
    ]


def mamba2_leaves(lead: Tuple[int, ...], a: dict) -> List[Leaf]:
    """A Mamba2 layer's leaves under ``blocks/``, stacked over the ``lead``
    dims."""
    dt = dtype(a)
    d = a["d_model"]
    d_inner, heads, n, conv_ch = mamba2_dims(a)
    f32 = torch.float32
    return [
        Leaf("blocks/a_log", lead + (heads,), f32, "ones"),
        Leaf("blocks/conv/w", lead + (CONV_K, conv_ch), dt, "normal",
             CONV_K ** -0.5),
        Leaf("blocks/d_skip", lead + (heads,), f32, "ones"),
        Leaf("blocks/dt_bias", lead + (heads,), f32, "zeros"),
        Leaf("blocks/norm/scale", lead + (d,), dt, "ones"),
        Leaf("blocks/out_norm/scale", lead + (d_inner,), dt, "ones"),
        Leaf("blocks/w_in", lead + (d, 2 * d_inner + 2 * n + heads), dt,
             "normal", d ** -0.5),
        Leaf("blocks/w_out", lead + (d_inner, d), dt, "normal",
             d_inner ** -0.5),
    ]


def layout(a: dict) -> List[Leaf]:
    """Every leaf of the ``arch`` of a configuration file, sorted by name
    (the order in which the trees flatten), as its family lays it out."""
    return families.load(a).layout(a)


def iter_draw(a: dict, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf in layout order, drawn on ``device``
    from ``seed``: N(0, 1) in f32, scaled by the leaf's std and rounded
    once to its dtype; norms' scales, ``a_log`` and ``d_skip`` ones,
    ``dt_bias`` zeros."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for leaf in layout(a):
        if leaf.init != "normal":
            fill = torch.ones if leaf.init == "ones" else torch.zeros
            yield leaf.name, fill(leaf.shape, dtype=leaf.dtype, device=device)
            continue
        t = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
        flat = t.view(-1)
        for lo in range(0, flat.numel(), CHUNK):
            n = min(CHUNK, flat.numel() - lo)
            x = torch.randn(n, generator=gen, device=device,
                            dtype=torch.float32)
            flat[lo:lo + n].copy_(x.mul_(leaf.std))
            del x
        yield leaf.name, t


def draw(a: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of :func:`iter_draw`."""
    return dict(iter_draw(a, seed, device))


def numel(a: dict) -> int:
    """Parameters of the layout (equal to :func:`accounting.param_count`)."""
    return sum(math.prod(leaf.shape) for leaf in layout(a))
