"""The hybrid family (zamba2): ``n_layers`` Mamba2 layers stacked under
``blocks/`` as (n_layers / shared_attn_every, shared_attn_every), and one
attention+MLP block (``shared_attn/``) whose weights are shared, applied
ahead of every ``shared_attn_every`` Mamba2 layers."""

from __future__ import annotations

from typing import Dict, List

import torch

from .. import accounting, weights
from ..reference import model
from ..weights import Leaf


def layout(a: dict) -> List[Leaf]:
    every = a["shared_attn_every"]
    out = weights.embed_leaves(a)
    out += weights.mamba2_leaves((a["n_layers"] // every, every), a)
    out += weights.attn_mlp_leaves("shared_attn", (), a)
    return sorted(out, key=lambda leaf: leaf.name)


def loss(w: Dict, a: dict, tokens: torch.Tensor, labels: torch.Tensor,
         mm: model.MM) -> torch.Tensor:
    x = w["embed"][tokens.long()]
    for layers in model.layers(w, "blocks/", 2):
        x = model.attn_mlp(w, "shared_attn/", x, a, mm)
        for layer in layers:
            x = x + model.mamba2(layer, x, a, mm)
    return model.head_loss(w, a, x, labels, mm)


def param_count(a: dict) -> int:
    return accounting.embed_params(a) + accounting.attn_mlp_params(a) \
        + a["n_layers"] * accounting.mamba2_params(a)


def applied_params(a: dict) -> int:
    """The shared block counted once per application."""
    return param_count(a) + (a["n_layers"] // a["shared_attn_every"] - 1) \
        * accounting.attn_mlp_params(a)


def attention_flops(a: dict, b: int, t: int) -> float:
    """The shared block's attention at each application."""
    return accounting.attention_layer_flops(a, b, t) \
        * (a["n_layers"] // a["shared_attn_every"])
