"""Attention: GQA + RoPE + sliding window + cross-attention + KV-cache
decode. The counterpart of ``repro.models.attention`` in plain PyTorch.

The reference's prefill runs a chunked flash formulation in jnp (no Pallas
kernel); here prefill attention is one masked softmax over the filled
prefix. Where its (B, Hq, T, S) f32 scores would pass ``ATTN_TILE_BYTES``
(a train_4k batch: 34 GB a layer for one granite-3-8b rank), it goes one
tile of ``cfg.attn_chunk_q`` query rows at a time, each row's softmax
over all its keys in one go (so a tile's rows are what the whole would
give them), and while autograd records each tile is recomputed in the
backward pass, so no more than one tile's scores are held at a time.
Scores and the softmax are f32
(the reference's ``preferred_element_type=f32``), masked with the finite
``NEG_INF``, so a row with every key masked gives 0, not NaN.

Caches are written in place: ``attn_apply`` returns the same
:class:`KVCache` tensors it was given, updated (the reference returns new
arrays).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import (as_dtensor, constrain, current_mesh, in_stream,
                              is_dtensor, local_call, mesh_sizes, shard_call)
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


def _heads(y: torch.Tensor, h: int, hd: int) -> torch.Tensor:
    """(B, T, h·hd) -> (B, T, h, hd). Under a mesh a feature dim split
    into parts that do not hold whole heads (a decode step's projection
    against weights split on their output over the data axes, 8 kv heads
    16 ways) is first laid out as attention takes it: the batch over the
    data axes, the heads over ``model`` where they divide it."""
    if is_dtensor(y):
        mesh = y.device_mesh
        parts = math.prod(mesh.size(d) for d, p in enumerate(y.placements)
                          if p.is_shard(2))
        if h % parts:
            model = "model" if h % mesh_sizes(mesh).get("model", 1) == 0 \
                else None
            y = constrain(y, ["batch", None, model])
    return y.reshape(*y.shape[:2], h, hd)


def _project_qkv(x: torch.Tensor, kv_x: torch.Tensor, wq: torch.Tensor,
                 wk: torch.Tensor, wv: torch.Tensor, cfg: ArchConfig, *,
                 cross: bool, use_rope: bool, q_positions, kv_positions):
    """q of ``x`` and k, v of ``kv_x``, (B, T, h, hd) each, as many heads
    as the weights' columns hold, with rope at their positions where
    ``use_rope`` (q only for cross-attention)."""
    hd = cfg.hd
    q, k, v = (_heads(a @ w, w.shape[-1] // hd, hd)
               for a, w in ((x, wq), (kv_x, wk), (kv_x, wv)))
    if use_rope:
        q = rope(q, q_positions, cfg.rope_theta)
        if not cross:
            k = rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_offset: int, causal: bool, window: Optional[int]) -> torch.Tensor:
    """The masked softmax of the queries at ``q_offset + i`` over keys at
    ``j``: q (B,T,Hq,Dh), k/v (B,S,Hkv,Dh) -> (B,T,Hq,Dh)."""
    b, t, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, t, hkv, g, dh)
    sc = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float())
    sc = sc * (1.0 / math.sqrt(dh))
    q_pos = q_offset + torch.arange(t, device=q.device)[:, None]
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


QKV_AXES = ["batch", None, "model", None]
ATTN_TILE_BYTES = 4 << 30   # the most f32 scores one call holds at once


def _tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: Optional[int],
           chunk_q: Optional[int], q_offset: int = 0) -> torch.Tensor:
    b, t, hq, _ = q.shape
    if chunk_q is None or t <= chunk_q \
            or 4 * b * hq * t * k.shape[1] <= ATTN_TILE_BYTES:
        return _attend(q, k, v, q_offset, causal, window)
    remat = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    tiles = []
    for s0 in range(0, t, chunk_q):
        args = (q[:, s0:s0 + chunk_q], k, v, q_offset + s0, causal, window)
        tiles.append(checkpoint(_attend, *args, use_reentrant=False)
                     if remat else _attend(*args))
    return torch.cat(tiles, dim=1)


def _heads_split(x) -> bool:
    return any(getattr(p, "dim", None) == 2 for p in x.placements)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      chunk_q: Optional[int] = None) -> torch.Tensor:
    """q: (B,T,Hq,Dh); k/v: (B,S,Hkv,Dh) with Hq % Hkv == 0. Query ``i`` sits
    at position ``i`` and key ``j`` at ``j`` (the reference's
    ``flash_attention`` with ``q_offset=0``). Queries go ``chunk_q`` rows
    at a time where the scores would pass ``ATTN_TILE_BYTES`` (all at once
    when ``chunk_q`` is None). Returns (B,T,Hq,Dh).

    Under a mesh, q/k/v take the batch over the data axes and their heads
    over ``model`` where the heads divide it, and each rank attends over
    its own batch rows and heads. Where q's heads split and the kv heads
    do not (GQA with Hkv < model), k and v are broadcast to Hq heads first,
    the reference's full-head form: its (Hkv, G) reshape kept no head split
    and gathered a KV tile a step."""
    q = constrain(q, QKV_AXES)
    k = constrain(k, QKV_AXES)
    v = constrain(v, QKV_AXES)
    run = functools.partial(_tiled, causal=causal, window=window,
                            chunk_q=chunk_q)
    if current_mesh() is None:
        return run(q, k, v)
    g = q.shape[2] // k.shape[2]
    if _heads_split(q) and not _heads_split(k):
        b, s, hkv, dh = k.shape
        k, v = (constrain(x[:, :, :, None].expand(b, s, hkv, g, dh)
                          .reshape(b, s, hkv * g, dh), QKV_AXES)
                for x in (k, v))
    return local_call(run, q.placements, q, k, v)


def _keep(pos: torch.Tensor, cache_len: Index, s: int,
          window: Optional[int], ring: bool) -> torch.Tensor:
    """Which of the keys at global positions ``pos`` (1, n) a query
    attends to, per row (B or 1, n); ``s`` is the cache's width."""
    clen = torch.as_tensor(cache_len, device=pos.device).reshape(-1, 1)
    if ring:
        # ring buffer of width s (== window): slot i holds absolute position
        # p - ((p - i) mod s); early steps (abs < 0) are empty
        p_cur = clen - 1
        return (p_cur - torch.remainder(p_cur - pos, s)) >= 0
    keep = pos < clen
    if window is not None:
        keep &= pos >= clen - window
    return keep


def decode_attention(q: torch.Tensor, cache: KVCache, cache_len: Index, *,
                     window: Optional[int] = None,
                     ring: bool = False) -> torch.Tensor:
    """One-token attention over a (possibly ring-buffered) KV cache.

    q: (B, 1, Hq, Dh); cache tensors (B, S, Hkv, Dh); ``cache_len`` = the
    number of valid entries, an int or a per-slot (B,) tensor (the new
    token's k/v already written at ``cache_len - 1``). A cache of DTensors
    is read where it lies (:func:`_decode_shards`).
    """
    if is_dtensor(cache.k):
        return _decode_shards(q, cache, cache_len, window, ring)
    return _decode_whole(q, cache.k, cache.v, cache_len, window, ring)


def _decode_whole(q, k, v, cache_len: Index, window: Optional[int],
                  ring: bool) -> torch.Tensor:
    """:func:`decode_attention` over every position of a cache."""
    b, _, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, dh)
    sc = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float())
    sc = sc * (1.0 / math.sqrt(dh))
    pos = torch.arange(s, device=q.device)[None, :]
    keep = _keep(pos, cache_len, s, window, ring).expand(b, s)
    sc = torch.where(keep[:, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def _rows_like(x: Index, cache_x) -> Index:
    """``x`` (an int, a 0-d or a per-slot (B,) tensor) laid out as the
    cache's batch rows: split where the cache splits its batch dim, whole
    on every other mesh dim."""
    if not isinstance(x, torch.Tensor):
        return x
    from torch.distributed.tensor import Replicate
    mesh = cache_x.device_mesh
    per_row = x.ndim == 1
    placements = tuple(p if per_row and p.is_shard(0) else Replicate()
                       for p in cache_x.placements)
    return as_dtensor(x, mesh).redistribute(mesh, placements)


def _partial_softmax(q, k, v, keep):
    """One shard of keys' part of the softmax: (row max, sum of exp, the
    exp-weighted sum of v) of q (B,1,Hq,Dh) over k/v (B,n,Hkv,Dh), keys
    masked by ``keep`` (B or 1, n); a row whose keys are all masked gives
    (NEG_INF, 0, 0)."""
    b, _, hq, dh = q.shape
    n, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dh)
    sc = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float())
    sc = sc * (1.0 / math.sqrt(dh))
    keep = keep.expand(b, n)[:, None, None, :]
    sc = torch.where(keep, sc, NEG_INF)
    m = sc.amax(dim=-1)                                      # (B,Hkv,G)
    p = torch.exp(sc - m[..., None]) * keep
    acc = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(), v.float())
    return m, p.sum(dim=-1), acc


def _decode_shards(q, cache: KVCache, cache_len: Index,
                   window: Optional[int], ring: bool) -> torch.Tensor:
    """:func:`decode_attention` over a cache of DTensors, each rank on its
    own shard, no cache byte moved. A cache split on heads (or not at
    all): q takes the same split and each rank attends over its heads with
    the plain arithmetic. A cache split on seq
    (tiny-kv archs): q is whole on that mesh dim, each rank scores its own
    keys at their global positions, and the partial softmaxes combine
    flash-decode style: all-reduce the row max, rescale, all-reduce the
    sums (what the reference's GSPMD derives from the seq-split cache)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    mesh, placements = cache.k.device_mesh, tuple(cache.k.placements)
    if any(p.is_shard(3) for p in placements):
        raise NotImplementedError("decode over a cache split on head_dim")
    seq_dims = [d for d, p in enumerate(placements) if p.is_shard(1)]
    if len(seq_dims) > 1:
        raise NotImplementedError("a cache split on seq over several mesh "
                                  "dims")
    s = cache.k.shape[1]
    q_pl = tuple(Replicate() if p.is_shard(1) else p for p in placements)
    q = as_dtensor(q, mesh).redistribute(mesh, q_pl)

    def attend(spans, q, k, v, clen):
        if not seq_dims:    # every position here: the plain arithmetic
            return _decode_whole(q, k, v, clen, window, ring)
        off, n = spans[1].get(1, (0, s))
        pos = off + torch.arange(n, device=q.device)[None, :]
        m, l, acc = _partial_softmax(q, k, v, _keep(pos, clen, s, window,
                                                    ring))
        group = (mesh, seq_dims[0])
        m_all = funcol.all_reduce(m, "max", group)
        scale = torch.exp(m - m_all)
        l = funcol.all_reduce(l * scale, "sum", group)
        acc = funcol.all_reduce(acc * scale[..., None], "sum", group)
        out = acc / l.clamp_min(1e-30)[..., None]
        return out.reshape(q.shape).to(q.dtype)

    return shard_call(attend, q_pl, q, cache.k, cache.v,
                      _rows_like(cache_len, cache.k))


def _span(cache: KVCache, k: torch.Tensor, widx: Index) -> Tuple[int, int]:
    """(start, length) of a span write, clamped like
    ``jax.lax.dynamic_update_slice``: the update always fits."""
    s_max, t = cache.k.shape[1], k.shape[1]
    if t > s_max:
        raise ValueError(f"{t} new entries do not fit a cache of {s_max}")
    return min(max(int(widx), 0), s_max - t), t


def _write(cache: KVCache, k: torch.Tensor, v: torch.Tensor, widx: Index,
           per_slot: bool) -> int:
    """Write the new k/v into ``cache`` in place; returns the end of the
    written span for a span write (0 for a per-slot write). A cache of
    DTensors is written where it lies (:func:`_write_shards`)."""
    if is_dtensor(cache.k):
        return _write_shards(cache, k, v, widx, per_slot)
    if per_slot:
        # per-slot decode write (continuous batching: ragged lengths)
        rows = torch.arange(k.shape[0], device=k.device)
        cols = widx.to(device=k.device, dtype=torch.long)
        cache.k[rows, cols] = k[:, 0].to(cache.k.dtype)
        cache.v[rows, cols] = v[:, 0].to(cache.v.dtype)
        return 0
    start, t = _span(cache, k, widx)
    cache.k[:, start:start + t] = k.to(cache.k.dtype)
    cache.v[:, start:start + t] = v.to(cache.v.dtype)
    return start + t


def _write_shards(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                  widx: Index, per_slot: bool) -> int:
    """:func:`_write` into a cache of DTensors: the new k/v take the
    cache's split of batch and heads (whole on seq), and each rank writes
    the positions its own seq shard holds, at ``widx - offset``."""
    from torch.distributed.tensor import Replicate
    mesh, s_max = cache.k.device_mesh, cache.k.shape[1]
    kv_pl = tuple(Replicate() if p.is_shard(1) else p
                  for p in cache.k.placements)
    k, v = (as_dtensor(x, mesh).redistribute(mesh, kv_pl) for x in (k, v))
    if per_slot:
        def write(spans, ck, cv, k, v, w):
            off, n = spans[0].get(1, (0, s_max))
            rows = torch.arange(ck.shape[0], device=ck.device)
            cols = w.to(torch.long) - off
            inside = ((cols >= 0) & (cols < n))[:, None, None]
            cols = cols.clamp(0, n - 1)
            # every row is written: the new k/v where its slot lies in this
            # rank's shard, the value already there elsewhere
            for c, new in ((ck, k), (cv, v)):
                c[rows, cols] = torch.where(inside, new[:, 0].to(c.dtype),
                                            c[rows, cols])

        shard_call(write, None, cache.k, cache.v, k, v,
                   _rows_like(widx, cache.k))
        return 0
    start, t = _span(cache, k, widx)

    def write_span(spans, ck, cv, k, v):
        off, n = spans[0].get(1, (0, s_max))
        lo, hi = max(start, off), min(start + t, off + n)
        if lo < hi:
            ck[:, lo - off:hi - off] = k[:, lo - start:hi - start].to(ck.dtype)
            cv[:, lo - off:hi - off] = v[:, lo - start:hi - start].to(cv.dtype)

    shard_call(write_span, None, cache.k, cache.v, k, v)
    return start + t


def _attn_local(x, kv_x, positions, wq, wk, wv, wo, *, cfg: ArchConfig,
                causal: bool, window: Optional[int], use_rope: bool,
                q_rows: Optional[Tuple[int, int]], kv_heads):
    """Attention without a cache on one rank's plain shards, from the
    projections in to the one out: the queries of rows ``q_rows`` (first,
    count; all when None) over the keys of every row of ``kv_x`` (``x``
    itself when None), the heads that ``wq``'s columns hold over the range
    ``kv_heads`` of kv heads in ``wk``/``wv`` (all their columns when
    None). :func:`attn_apply`'s arithmetic, a slice of it."""
    hd = cfg.hd
    if kv_heads is not None:
        wk, wv = (w[:, kv_heads.start * hd:kv_heads.stop * hd]
                  for w in (wk, wv))
    xq, pq, q_off = x, positions, 0
    if q_rows is not None:
        q_off, n = q_rows
        xq, pq = x[:, q_off:q_off + n], positions[:, q_off:q_off + n]
    cross = kv_x is not None
    q, k, v = _project_qkv(xq, kv_x if cross else x, wq, wk, wv, cfg,
                           cross=cross, use_rope=use_rope, q_positions=pq,
                           kv_positions=positions)
    out = _tiled(q, k, v, causal=causal and not cross, window=window,
                 chunk_q=cfg.attn_chunk_q, q_offset=q_off)
    return out.reshape(*out.shape[:2], -1) @ wo


def _kv_heads_of(q_first: int, nq: int, hq: int, hkv: int
                 ) -> Optional[range]:
    """The kv heads that query heads ``[q_first, q_first + nq)`` read, where
    each of them serves an equal run of those query heads (``_attend``'s
    grouping); None where they do not."""
    g = hq // hkv
    idx = [h // g for h in range(q_first, q_first + nq)]
    n = idx[-1] - idx[0] + 1
    if nq % n == 0 and idx == [idx[0] + i // (nq // n) for i in range(nq)]:
        return range(idx[0], idx[0] + n)
    return None


def _attn_stream(p: Params, x: torch.Tensor, kv_x: Optional[torch.Tensor],
                 cfg: ArchConfig, positions: torch.Tensor, *, causal: bool,
                 window: Optional[int], use_rope: bool) -> torch.Tensor:
    """:func:`_attn_local` over the residual stream on a mesh, each rank
    on its own shards: the heads over ``model`` where they divide it
    (``wq``/``wk``/``wv`` column-parallel, ``wo`` row-parallel: the output
    is Partial over ``model``); where the kv heads do not divide it (8 of
    granite's on 16 ranks) each rank takes the whole ``wk``/``wv`` and
    projects only the kv heads its query heads read. Where the query heads
    do not split so (whisper-tiny's 6 on 4), each rank takes its share of
    the query rows, over every key, with whole weights: the output is split
    on rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from ..dist.sharding import (entering, model_coordinate, shard_call,
                                 split_like, use_weight)
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    r, m = model_coordinate()
    x = entering(x)
    t = x.shape[1]
    kv_split = m > 1 and hq % m == 0 and hkv % m == 0
    kv_heads = (_kv_heads_of(r * hq // m, hq // m, hq, hkv)
                if m > 1 and hq % m == 0 and not kv_split else None)
    heads = kv_split or kv_heads is not None
    rows = m > 1 and not heads and t % m == 0
    fn = functools.partial(
        _attn_local, cfg=cfg, causal=causal, window=window, use_rope=use_rope,
        q_rows=(r * t // m, t // m) if rows else None, kv_heads=kv_heads)
    model = Partial() if heads else Shard(1) if rows else Replicate()
    kv_dim = 1 if kv_split else None
    return shard_call(
        lambda _, *a: fn(*a), split_like(x, model), x,
        None if kv_x is None else entering(kv_x),
        constrain(positions, ["batch"]),
        use_weight(p["wq"], 1 if heads else None),
        use_weight(p["wk"], kv_dim), use_weight(p["wv"], kv_dim),
        use_weight(p["wo"], 0 if heads else None))


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
    if cache is None and in_stream(x):
        return _attn_stream(p, x, kv_x, cfg, positions, causal=causal,
                            window=window, use_rope=use_rope), None
    cross = kv_x is not None
    q, k, v = _project_qkv(x, kv_x if cross else x, p["wq"], p["wk"],
                           p["wv"], cfg, cross=cross, use_rope=use_rope,
                           q_positions=positions, kv_positions=positions)

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
        # prefill: attend over the filled prefix (masked by causal), which
        # is the new k/v itself where the write began at 0 (a cache split
        # on seq is then not gathered to be read back)
        if end == x.shape[1]:
            k, v = k.to(cache.k.dtype), v.to(cache.v.dtype)
        else:
            k, v = cache.k[:, :end], cache.v[:, :end]

    out = prefill_attention(q, k, v, causal=causal and not cross,
                            window=window, chunk_q=cfg.attn_chunk_q)
    return out.reshape(*x.shape[:2], -1) @ p["wo"], new_cache


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                  device, lead: Tuple[int, ...] = ()) -> KVCache:
    """A zero cache of (B, S, Hkv, Dh), with the leading stack axes
    ``lead`` (``(L,)`` for a stack of L layers)."""
    shape = lead + (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
