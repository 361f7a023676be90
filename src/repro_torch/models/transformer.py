"""LM assembly for the attention + MLP/MoE families (``dense``, ``moe``),
the counterpart of ``repro.models.transformer`` in plain PyTorch.

Params are nested dicts of tensors in the reference's layout: every leaf
of ``params["blocks"]`` carries a leading L axis (the reference scans over
it), and :func:`forward` runs a Python loop over ``l`` on views of those
stacked tensors, so a param tree is the same set of leaves, names and
shapes in both packages and a stored table loads into either. Caches keep
the same stacking: ``caches["blocks"]`` is one :class:`KVCache` of
(L, B, S, Hkv, Dh) tensors, written in place, and ``caches["index"]`` the
per-slot lengths (B,).

The ``vlm``, ``audio``, ``hybrid`` and ``ssm`` families (``models/ssm.py``)
are not ported yet and raise ``NotImplementedError``. Serving needs no
remat and no scan, so neither is here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..tree import leaves, rebuild, tree_map
from .attention import Index, KVCache, attn_apply, attn_init, init_kv_cache
from .config import ArchConfig
from .layers import (Params, dense_init, dtype_of, embed, embed_init, mlp,
                     mlp_init, rmsnorm, rmsnorm_init, unembed)
from .moe import moe_apply, moe_init

PORTED_FAMILIES = ("dense", "moe")


def check_family(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port lacks."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP.md, Queue 1, item 1: the vlm, audio, hybrid and ssm "
            f"families with models/ssm.py)")


def _stack(trees):
    """One tree whose leaves are the stacked leaves of ``trees``."""
    cols = zip(*[[leaf for _, leaf in leaves(t)] for t in trees])
    return rebuild(trees[0], iter([torch.stack(c) for c in cols]))


def _attn_mlp_layer_init(gen, cfg: ArchConfig, dtype, device,
                         use_moe: bool) -> Params:
    p: Params = {"ln1": rmsnorm_init(cfg.d_model, dtype, device),
                 "attn": attn_init(gen, cfg, dtype, device),
                 "ln2": rmsnorm_init(cfg.d_model, dtype, device)}
    if use_moe:
        p["moe"] = moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator] = None, *,
                device: Any = "cuda") -> Params:
    """Random params drawn from ``gen`` on ``device`` (``"meta"`` gives a
    template of shapes and dtypes for :meth:`ModelRepo.load`)."""
    check_family(cfg)
    dtype = dtype_of(cfg.dtype)
    params: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype, device)
    params["blocks"] = _stack([
        _attn_mlp_layer_init(gen, cfg, dtype, device, cfg.family == "moe")
        for _ in range(cfg.n_layers)])
    return params


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                device: Any = "cuda") -> Dict[str, Any]:
    """Zero KV caches for ``batch`` slots of ``max_len`` positions."""
    check_family(cfg)
    return {"index": torch.zeros((batch,), dtype=torch.int32, device=device),
            "blocks": init_kv_cache(cfg, batch, max_len, dtype_of(cfg.dtype),
                                    device, layers=cfg.n_layers)}


def _apply_attn_mlp(pl: Params, x, cfg: ArchConfig, positions, *,
                    use_moe: bool, window=None,
                    cache: Optional[KVCache] = None, cache_index=None):
    h, _ = attn_apply(pl["attn"], rmsnorm(pl["ln1"], x, cfg.norm_eps), cfg,
                      positions=positions, window=window, cache=cache,
                      cache_index=cache_index)
    x = x + h
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if use_moe:
        h2, aux = moe_apply(pl["moe"], rmsnorm(pl["ln2"], x, cfg.norm_eps), cfg)
    else:
        h2 = mlp(pl["mlp"], rmsnorm(pl["ln2"], x, cfg.norm_eps))
    return x + h2, aux


def _backbone(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
              caches: Optional[Dict[str, Any]] = None,
              cache_index: Optional[Index] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """tokens (B, T) -> (hidden (B, T, D) after the final norm, caches',
    aux)."""
    check_family(cfg)
    x = embed(params["embed"], tokens)
    t = tokens.shape[1]
    steps = torch.arange(t, device=tokens.device)
    base = cache_index if cache_index is not None else 0
    if isinstance(base, torch.Tensor) and base.ndim == 1:
        positions = base[:, None].long() + steps[None, :]  # per slot
    else:
        positions = (int(base) + steps).expand(tokens.shape)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg.n_layers):
        pl = tree_map(lambda v: v[l], params["blocks"])
        cache = None
        if caches is not None:
            cache = KVCache(caches["blocks"].k[l], caches["blocks"].v[l])
        x, a = _apply_attn_mlp(pl, x, cfg, positions,
                               use_moe=cfg.family == "moe",
                               window=cfg.window, cache=cache,
                               cache_index=cache_index)
        aux = aux + a
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    new_caches = caches
    if caches is not None and cache_index is not None:
        nxt = cache_index + t
        if not isinstance(nxt, torch.Tensor) or nxt.ndim == 0:
            nxt = torch.full((tokens.shape[0],), int(nxt), dtype=torch.int32,
                             device=tokens.device)
        new_caches = dict(caches, index=nxt.to(torch.int32))
    return h, new_caches, aux


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, **kw
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """tokens (B, T) -> (logits (B, T, V) f32, caches', aux loss); ``kw``:
    ``caches`` and ``cache_index`` (see :func:`prefill`,
    :func:`decode_step`)."""
    h, new_caches, aux = _backbone(params, cfg, tokens, **kw)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed(table, h, tied=cfg.tie_embeddings), new_caches, aux


def prefill(params, cfg, tokens, caches):
    """Fill empty ``caches`` with ``tokens`` (B, T) from position 0."""
    return forward(params, cfg, tokens, caches=caches, cache_index=0)


def decode_step(params, cfg, token, caches):
    """token: (B, 1); the caches carry their own per-slot index."""
    return forward(params, cfg, token, caches=caches,
                   cache_index=caches["index"])


def param_count(params: Params) -> int:
    """Total number of parameters."""
    return sum(leaf.numel() for _, leaf in leaves(params))


def active_param_count(params: Params, cfg: ArchConfig) -> int:
    """MoE: only top_k/n_experts of the expert params are active per token."""
    total = 0
    for name, leaf in leaves(params):
        if cfg.n_experts and "moe" in name and (
                "w_gate" in name or "w_up" in name or "w_down" in name):
            total += leaf.numel() * cfg.top_k // cfg.n_experts
        else:
            total += leaf.numel()
    return total
