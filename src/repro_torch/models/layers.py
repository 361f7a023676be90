"""Shared layers: norms, projections, RoPE, SwiGLU. Plain PyTorch over
nested dicts of tensors, the counterpart of ``repro.models.layers``.

Initialisers take an explicit ``torch.Generator`` (or None for torch's
default one) and a device; a ``"meta"`` device gives a template with
shapes and dtypes and no storage.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..dist.sharding import (as_dtensor, constrain, current_mesh, entering,
                             in_stream, is_dtensor, model_coordinate, shard_call,
                             split_like, use_weight)

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def normal(shape, scale: float, dtype: torch.dtype,
           gen: Optional[torch.Generator], device: Any) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in f32 from ``gen``, then cast to
    ``dtype``, as the reference draws (``jax.random.normal`` in f32)."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    """A (d_in, d_out) projection with std ``1/sqrt(d_in)``."""
    return normal((d_in, d_out), 1.0 / math.sqrt(d_in), dtype, gen, device)


def embed_init(gen, vocab: int, d: int, dtype, device) -> torch.Tensor:
    """A (vocab, d) embedding table with std 0.02."""
    return normal((vocab, d), 0.02, dtype, gen, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, device) -> Params:
    """RMSNorm params: a unit ``scale`` of width ``d``."""
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in f32, returned in ``x``'s dtype. Over the
    residual stream on a mesh the scale is taken whole (it is split on d
    over ``model``), so the output keeps the stream's layout."""
    scale = use_weight(p["scale"], None) if in_stream(x) else p["scale"]
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, Dh); positions broadcastable to (..., T). Half-split
    rotation with f32 angles, as the reference."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., :, None].float() * freqs          # (..., T, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_init(gen, d: int, f: int, dtype, device) -> Params:
    """SwiGLU params: ``w_gate``, ``w_up`` (d, f) and ``w_down`` (f, d)."""
    return {"w_gate": dense_init(gen, d, f, dtype, device),
            "w_up": dense_init(gen, d, f, dtype, device),
            "w_down": dense_init(gen, f, d, dtype, device)}


def _swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * x W_up) W_down`` in ``x``'s dtype. Over
    the residual stream on a mesh (``in_stream``) it runs on local shards
    of the stream whole on T: ``w_gate`` and ``w_up`` split on f
    (column-parallel), so the SiLU and the product need no collective, and
    ``w_down`` on f (row-parallel), so the output is Partial over ``model``
    until :func:`~repro_torch.dist.sharding.rejoin` reduces it."""
    if not in_stream(x):
        return _swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    from torch.distributed.tensor import Partial, Replicate
    _, m = model_coordinate()
    split = m > 1 and p["w_gate"].shape[1] % m == 0
    x = entering(x)
    return shard_call(lambda _, *a: _swiglu(*a),
                      split_like(x, Partial() if split else Replicate()),
                      x, use_weight(p["w_gate"], 1), use_weight(p["w_up"], 1),
                      use_weight(p["w_down"], 0))


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``tokens`` (``F.embedding``, whose backward
    DTensor can place on a sharded table). Under a mesh the table is laid
    out with d over ``model`` (replicated where d does not divide it), so
    the rows come back with d over ``model``: a vocab-sharded table would
    give a masked partial sum, which DTensor cannot reduce for a batch
    sharded over another mesh dim. Fewer tokens than table rows (a decode
    step) are looked up where the table lies instead (:func:`_lookup`):
    the rows' all-reduce moves less than the table."""
    if current_mesh() is not None and is_dtensor(table) \
            and tokens.numel() < table.shape[0]:
        return constrain(_lookup(table, tokens), ["batch", None, "model"])
    return F.embedding(tokens, constrain(table, [None, "model"]))


def _lookup(table, tokens: torch.Tensor) -> torch.Tensor:
    """``F.embedding`` of a DTensor table without moving it: every rank
    takes all the tokens and looks up the rows of its own vocab shard (0
    for a token outside it), so the rows come back Partial over the mesh
    dims that split the vocab, and split on d where the table's d is."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tokens = as_dtensor(tokens, mesh).redistribute(
        mesh, (Replicate(),) * mesh.ndim)
    out = tuple(Partial() if p.is_shard(0) else Shard(2) if p.is_shard(1)
                else Replicate() for p in table.placements)

    def look(spans, tab, tok):
        off, n = spans[0].get(0, (0, tab.shape[0]))
        idx = tok.long() - off
        inside = ((idx >= 0) & (idx < n))[..., None]
        return F.embedding(idx.clamp(0, n - 1), tab) * inside.to(tab.dtype)

    return shard_call(look, out, table, tokens)


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, *,
            tied: bool) -> torch.Tensor:
    """Logits in f32: ``x @ head`` (or ``x @ table.T`` when tied). Under a
    mesh a split table is gathered whole first where the rank has more
    rows than the table's bytes over 4 V: contracting over its sharded d
    would leave (B, T, V) f32 logits Partial, and their all-reduce would
    move more than the table. A decode step's few rows take that
    all-reduce instead (1.6 MB for 8 rows of granite-3-8b, where the table
    is 403 MB)."""
    v = table_or_head.shape[0] if tied else table_or_head.shape[1]
    local = x.to_local() if is_dtensor(x) else x
    rows = local.numel() // max(local.shape[-1], 1)
    table_bytes = table_or_head.numel() * table_or_head.element_size()
    split = is_dtensor(table_or_head) and any(
        p.is_shard() for p in table_or_head.placements)
    if current_mesh() is None or not split or 4 * rows * v > table_bytes:
        w = constrain(table_or_head, [None, None])
        w = w.t() if tied else w
        return x.float() @ w.float()
    w = table_or_head.t() if tied else table_or_head
    return constrain(x.float() @ w.float(), ["batch", None, None])
