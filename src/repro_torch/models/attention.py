"""Attention: GQA + RoPE + sliding window + cross-attention + KV-cache
decode. The counterpart of ``repro.models.attention`` in plain PyTorch.

The reference's prefill runs a chunked flash formulation in jnp (no Pallas
kernel); here prefill attention is one masked softmax over the filled
prefix, which is small at serving lengths. Scores and the softmax are f32
(the reference's ``preferred_element_type=f32``), masked with the finite
``NEG_INF``, so a row with every key masked gives 0, not NaN.

Caches are written in place: ``attn_apply`` returns the same
:class:`KVCache` tensors it was given, updated (the reference returns new
arrays).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from .config import ArchConfig
from .layers import Params, dense_init, rope

NEG_INF = -1e30

Index = Union[int, torch.Tensor]


class KVCache(NamedTuple):
    """One layer's KV cache (or a stack of them, with a leading L axis)."""

    k: torch.Tensor   # (B, S_max, Hkv, Dh)
    v: torch.Tensor   # (B, S_max, Hkv, Dh)


def attn_init(gen, cfg: ArchConfig, dtype, device,
              d_model: Optional[int] = None,
              kv_d_model: Optional[int] = None) -> Params:
    """``wq``, ``wk``, ``wv``, ``wo`` of one attention layer."""
    d = d_model or cfg.d_model
    dkv = kv_d_model or d
    hd = cfg.hd
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, device),
        "wk": dense_init(gen, dkv, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, dkv, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, device),
    }


def _project_qkv(p: Params, x: torch.Tensor, kv_x: torch.Tensor,
                 cfg: ArchConfig):
    b, t, _ = x.shape
    s = kv_x.shape[1]
    hd = cfg.hd
    q = (x @ p["wq"]).reshape(b, t, cfg.n_heads, hd)
    k = (kv_x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (kv_x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    return q, k, v


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      window: Optional[int] = None) -> torch.Tensor:
    """q: (B,T,Hq,Dh); k/v: (B,S,Hkv,Dh) with Hq % Hkv == 0. Query ``i`` sits
    at position ``i`` and key ``j`` at ``j`` (the reference's
    ``flash_attention`` with ``q_offset=0``). Returns (B,T,Hq,Dh)."""
    b, t, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, t, hkv, g, dh)
    sc = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float())
    sc = sc * (1.0 / math.sqrt(dh))
    q_pos = torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    keep = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        keep &= q_pos >= k_pos
    if window is not None:
        keep &= q_pos - k_pos < window
    sc = torch.where(keep, sc, NEG_INF)
    # masked again after the subtraction: a row with every key masked has
    # sc == max == NEG_INF, and exp(0) would count it
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True)) * keep
    denom = p.sum(dim=-1).clamp_min(1e-30)                  # (B,Hkv,G,T)
    acc = torch.einsum("bhgts,bshd->bhgtd", p.to(v.dtype).float(), v.float())
    out = acc / denom[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, dh).to(q.dtype)


def decode_attention(q: torch.Tensor, cache: KVCache, cache_len: Index, *,
                     window: Optional[int] = None,
                     ring: bool = False) -> torch.Tensor:
    """One-token attention over a (possibly ring-buffered) KV cache.

    q: (B, 1, Hq, Dh); cache tensors (B, S, Hkv, Dh); ``cache_len`` = the
    number of valid entries, an int or a per-slot (B,) tensor (the new
    token's k/v already written at ``cache_len - 1``).
    """
    b, _, hq, dh = q.shape
    s, hkv = cache.k.shape[1], cache.k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, dh)
    sc = torch.einsum("bhgd,bkhd->bhgk", qg.float(), cache.k.float())
    sc = sc * (1.0 / math.sqrt(dh))
    pos = torch.arange(s, device=q.device)[None, :]
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    if ring:
        # ring buffer of width s (== window): slot i holds absolute position
        # p - ((p - i) mod s); early steps (abs < 0) are empty
        p_cur = clen - 1
        keep = (p_cur - torch.remainder(p_cur - pos, s)) >= 0
    else:
        keep = pos < clen
        if window is not None:
            keep &= pos >= clen - window
    keep = keep.expand(b, s)
    sc = torch.where(keep[:, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(cache.v.dtype).float(),
                       cache.v.float())
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def _write(cache: KVCache, k: torch.Tensor, v: torch.Tensor, widx: Index,
           per_slot: bool) -> int:
    """Write the new k/v into ``cache`` in place; returns the end of the
    written span for a span write (0 for a per-slot write)."""
    if per_slot:
        # per-slot decode write (continuous batching: ragged lengths)
        rows = torch.arange(k.shape[0], device=k.device)
        cols = widx.to(device=k.device, dtype=torch.long)
        cache.k[rows, cols] = k[:, 0].to(cache.k.dtype)
        cache.v[rows, cols] = v[:, 0].to(cache.v.dtype)
        return 0
    s_max, t = cache.k.shape[1], k.shape[1]
    if t > s_max:
        raise ValueError(f"{t} new entries do not fit a cache of {s_max}")
    # clamped like jax.lax.dynamic_update_slice: the update always fits
    start = min(max(int(widx), 0), s_max - t)
    cache.k[:, start:start + t] = k.to(cache.k.dtype)
    cache.v[:, start:start + t] = v.to(cache.v.dtype)
    return start + t


def attn_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
               positions: torch.Tensor,
               kv_x: Optional[torch.Tensor] = None,
               causal: bool = True,
               window: Optional[int] = None,
               use_rope: bool = True,
               cache: Optional[KVCache] = None,
               cache_index: Optional[Index] = None,
               ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Self- or cross-attention; prefill (cache filled) or decode.

    * no cache:    ``cache=None``
    * prefill:     an empty ``cache``, ``cache_index=0``: fills [0, T)
    * decode:      a filled ``cache``, ``cache_index`` = the current length
      (an int, or per slot a (B,) tensor); ``x`` is (B, 1, D)
    * cross-attn:  ``kv_x`` = encoder/image states, ``use_rope=False``,
      ``causal=False``; no cache is written
    """
    cross = kv_x is not None
    q, k, v = _project_qkv(p, x, kv_x if cross else x, cfg)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        if not cross:
            k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None and not cross:
        s_max = cache.k.shape[1]
        # ring mode: windowed attention serving with a window-sized cache
        ring = window is not None and s_max <= window
        per_slot = isinstance(cache_index, torch.Tensor) \
            and cache_index.ndim == 1 and x.shape[1] == 1
        if isinstance(cache_index, torch.Tensor) and not per_slot:
            cache_index = int(cache_index)
        widx = cache_index % s_max if ring else cache_index
        end = _write(cache, k, v, widx, per_slot)
        new_cache = cache
        if x.shape[1] == 1:  # decode step
            out = decode_attention(q, cache, cache_index + 1, window=window,
                                   ring=ring)
            return out.reshape(*x.shape[:2], -1) @ p["wo"], new_cache
        # prefill: attend over the filled prefix (masked by causal)
        k, v = cache.k[:, :end], cache.v[:, :end]

    out = prefill_attention(q, k, v, causal=causal and not cross,
                            window=window)
    return out.reshape(*x.shape[:2], -1) @ p["wo"], new_cache


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                  device, layers: Optional[int] = None) -> KVCache:
    """A zero cache of (B, S, Hkv, Dh), or (L, B, S, Hkv, Dh) for a stack."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    if layers is not None:
        shape = (layers,) + shape
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
