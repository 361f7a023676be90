"""Analytic FLOP accounting per (arch x shape), the port of
``repro.analysis.accounting``: the MODEL_FLOPS side of the roofline ratio
(6·N·D for training, 2·N·D forward-only for serving, N := active params
for MoE). Attention's O(T·S) term is reported separately, so the ratio
stays the usual definition."""

from __future__ import annotations

from typing import Dict

from ..models import transformer
from ..models.config import ArchConfig


def param_counts(cfg: ArchConfig) -> Dict[str, int]:
    """Total and active (MoE: top_k of n_experts) parameters, from a meta
    init: shapes only, no storage."""
    params = transformer.init_params(cfg, device="meta")
    return {"total": int(transformer.param_count(params)),
            "active": int(transformer.active_param_count(params, cfg))}


def attention_flops(cfg: ArchConfig, b: int, t: int, s: int) -> float:
    """Score+value matmuls: 2 · 2 · B · Hq · T · S · hd (fwd)."""
    if cfg.family in ("ssm",):
        return 0.0
    n_attn_layers = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn_layers = cfg.n_layers // cfg.shared_attn_every
    window = cfg.window
    eff_s = min(s, window) if window else s
    return 4.0 * b * cfg.n_heads * t * eff_s * cfg.hd * n_attn_layers


def model_flops(cfg: ArchConfig, kind: str, b: int, t: int,
                cache_len: int = 0) -> Dict[str, float]:
    """``model_flops`` (6·N·D train, 2·N·D prefill / decode), ``attn_flops``,
    ``tokens`` and the param counts, for a step of ``kind``."""
    counts = param_counts(cfg)
    n_act = counts["active"]
    if kind == "train":
        tokens = b * t
        core = 6.0 * n_act * tokens
        attn = 3.0 * attention_flops(cfg, b, t, t) / 2.0 * 2.0  # fwd+bwd ≈ 3×fwd
    elif kind == "prefill":
        tokens = b * t
        core = 2.0 * n_act * tokens
        attn = attention_flops(cfg, b, t, t) / 2.0   # causal halves the area
    else:  # decode
        tokens = b * 1
        core = 2.0 * n_act * tokens
        attn = attention_flops(cfg, b, 1, max(cache_len, 1))
    return {"model_flops": core, "attn_flops": attn,
            "tokens": float(tokens), **{f"params_{k}": v
                                        for k, v in counts.items()}}
