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
    """RMSNorm computed in f32, returned in ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


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


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * x W_up) W_down`` in ``x``'s dtype."""
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``tokens``."""
    return table[tokens]


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, *,
            tied: bool) -> torch.Tensor:
    """Logits in f32: ``x @ head`` (or ``x @ table.T`` when tied)."""
    w = table_or_head.t() if tied else table_or_head
    return x.float() @ w.float()
