"""Frozen FLOP and parameter arithmetic of a training step.

A copy of the port's ``analysis/accounting.py`` (6 N D plus attention for
a training step), computed from a configuration's sizes alone rather than
from the program's parameter tree, so that a later change to the program
cannot move the yardstick.
"""

from __future__ import annotations

from typing import Dict


def _attn_mlp_params(a: Dict) -> int:
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


def _mamba2_params(a: Dict) -> int:
    d = a["d_model"]
    d_inner, heads, n, conv_ch = mamba2_dims(a)
    return (d + d * (2 * d_inner + 2 * n + heads) + 4 * conv_ch + 3 * heads
            + d_inner + d_inner * d)


def param_count(a: Dict) -> int:
    """Parameters of the dense and hybrid families (``arch`` of a
    configuration file): embedding, final norm, untied head, the layers."""
    d, v = a["d_model"], a["vocab_size"]
    n = v * d + d + (0 if a.get("tie_embeddings") else d * v)
    if a["family"] == "dense":
        return n + a["n_layers"] * _attn_mlp_params(a)
    if a["family"] == "hybrid":
        return n + _attn_mlp_params(a) + a["n_layers"] * _mamba2_params(a)
    raise ValueError(f"no parameter count for family {a['family']!r}")


def attention_flops(a: Dict, b: int, t: int) -> float:
    """Forward score and value matmuls over the whole (T, T) square:
    4 B Hq T T hd per attention layer (the port's ``attention_flops``)."""
    layers = a["n_layers"]
    if a["family"] == "hybrid":
        layers = a["n_layers"] // a["shared_attn_every"]
    return 4.0 * b * a["n_heads"] * t * t * a["head_dim"] * layers


def applied_params(a: Dict) -> int:
    """Parameters a token passes through: the hybrid family's shared block
    once per application (every ``shared_attn_every`` layers)."""
    n = param_count(a)
    if a["family"] == "hybrid":
        n += (a["n_layers"] // a["shared_attn_every"] - 1) * _attn_mlp_params(a)
    return n


def train_step_flops(a: Dict, b: int, t: int) -> float:
    """Model FLOPs of one training step of B x T tokens: 6 N B T for the
    weights, N counting a shared block at each application, plus 3x the
    forward attention FLOPs (the port's ``model_flops(kind="train")``,
    ``model_flops + attn_flops``, which counts a shared block once)."""
    return 6.0 * applied_params(a) * b * t + 3.0 * attention_flops(a, b, t)
