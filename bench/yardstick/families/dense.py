"""The dense family (granite): ``n_layers`` pre-norm attention+MLP blocks
stacked under ``blocks/``, between the embedding and the final norm and
head."""

from __future__ import annotations

from typing import Dict, List

import torch

from .. import accounting, weights
from ..reference import model
from ..weights import Leaf


def layout(a: dict) -> List[Leaf]:
    out = weights.embed_leaves(a)
    out += weights.attn_mlp_leaves("blocks", (a["n_layers"],), a)
    return sorted(out, key=lambda leaf: leaf.name)


def loss(w: Dict, a: dict, tokens: torch.Tensor, labels: torch.Tensor,
         mm: model.MM) -> torch.Tensor:
    x = w["embed"][tokens.long()]
    for layer in model.layers(w, "blocks/", 1):
        x = model.attn_mlp(layer, "", x, a, mm)
    return model.head_loss(w, a, x, labels, mm)


def param_count(a: dict) -> int:
    return accounting.embed_params(a) \
        + a["n_layers"] * accounting.attn_mlp_params(a)


def applied_params(a: dict) -> int:
    return param_count(a)


def attention_flops(a: dict, b: int, t: int) -> float:
    return accounting.attention_layer_flops(a, b, t) * a["n_layers"]
