"""Frozen FLOP and parameter arithmetic of a training step.

A copy of the port's ``analysis/accounting.py`` (6 N D plus attention for
a training step), computed from a configuration's sizes alone rather than
from the program's parameter tree, so that a later change to the program
cannot move the yardstick. What differs by family (:mod:`.families`) is
counted by the family's module from the pieces here.
"""

from __future__ import annotations

from typing import Dict

from . import families


def embed_params(a: Dict) -> int:
    """The embedding, the final norm and an untied head."""
    d, v = a["d_model"], a["vocab_size"]
    return v * d + d + (0 if a.get("tie_embeddings") else d * v)


def attn_mlp_params(a: Dict) -> int:
    """One pre-norm attention+MLP block: two norm scales, the GQA
    projections, the SwiGLU MLP."""
    d, hd = a["d_model"], a["head_dim"]
    attn = d * a["n_heads"] * hd + 2 * d * a["n_kv_heads"] * hd \
        + a["n_heads"] * hd * d
    return 2 * d + attn + 3 * d * a["d_ff"]


def mamba2_dims(a: Dict):
    """(d_inner, heads, state N, conv channels) of a Mamba2 layer."""
    d_inner = a["ssm_expand"] * a["d_model"]
    heads = d_inner // a["ssm_head_dim"]
    n = a["ssm_state"]
    return d_inner, heads, n, d_inner + 2 * n


def mamba2_params(a: Dict) -> int:
    """One Mamba2 layer: its norm, ``w_in``, the conv, ``a_log``,
    ``dt_bias`` and ``d_skip``, the inner norm, ``w_out``."""
    d = a["d_model"]
    d_inner, heads, n, conv_ch = mamba2_dims(a)
    return (d + d * (2 * d_inner + 2 * n + heads) + 4 * conv_ch + 3 * heads
            + d_inner + d_inner * d)


def attention_layer_flops(a: Dict, b: int, t: int) -> float:
    """Forward score and value matmuls of one attention layer over the
    whole (T, T) square: 4 B Hq T T hd (the port's ``attention_flops``)."""
    return 4.0 * b * a["n_heads"] * t * t * a["head_dim"]


def param_count(a: Dict) -> int:
    """Parameters of the ``arch`` of a configuration file, by its family."""
    return families.load(a).param_count(a)


def attention_flops(a: Dict, b: int, t: int) -> float:
    """Forward attention FLOPs of B x T tokens, by the family."""
    return families.load(a).attention_flops(a, b, t)


def applied_params(a: Dict) -> int:
    """Parameters a token passes through, by the family."""
    return families.load(a).applied_params(a)


def train_step_flops(a: Dict, b: int, t: int) -> float:
    """Model FLOPs of one training step of B x T tokens: 6 N B T for the
    weights, N counting a shared block at each application, plus 3x the
    forward attention FLOPs (the port's ``model_flops(kind="train")``,
    ``model_flops + attn_flops``, which counts a shared block once)."""
    return 6.0 * applied_params(a) * b * t + 3.0 * attention_flops(a, b, t)
