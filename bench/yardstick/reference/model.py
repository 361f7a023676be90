"""The plain reference's layers in PyTorch, and the loss of a
configuration by its family's module (``yardstick/families/<family>.py``:
the dense family, granite; the hybrid family, zamba2), which the tests
hold against the program's f32 path.

Weights are a flat ``{name: tensor}`` dict named as in
:func:`yardstick.weights.layout`. Every activation is f32. ``mm`` computes
each projection (``x @ w``): :func:`matmul` in f32, or, for the control,
:func:`fp8_matmul`, which rounds both operands to float8 first.

The layers follow the configurations as the repository defines them:
pre-norm RMSNorm blocks; GQA attention with half-split RoPE, causal
softmax over all keys; a SwiGLU MLP; a head tied to the embedding
(its transpose) where the weights hold no ``unembed``; a mean
cross-entropy. A Mamba2 layer:
``w_in`` splits into z, (x, B, C) and dt; (x, B, C) pass a causal
depthwise conv of width 4 and SiLU; dt = softplus(dt + dt_bias), the
decay a = exp(-exp(a_log) dt); the SSD recurrence h_t = a_t h_{t-1} +
B_t (dt x_t)^T, y_t = h_t^T C_t (one group: B and C shared by the heads)
plus d_skip x_t; RMSNorm over the inner width times SiLU(z); ``w_out``.
The recurrence is computed here in chunks of ``SSD_CHUNK`` tokens by its
dual (masked decay matrix) form.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from .. import families
from ..accounting import mamba2_dims

SSD_CHUNK = 256
MM = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (float8) under one per-tensor scale that
    maps its largest magnitude to the format's largest value, back in f32."""
    top = torch.finfo(dtype).max
    s = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / s).to(dtype).to(torch.float32) * s


class _Fp8MM(torch.autograd.Function):
    """``x @ w`` with both operands in float8 e4m3 and the backward's
    incoming gradient in float8 e5m2, products summed in f32: the usual
    float8 training recipe for a linear layer."""

    @staticmethod
    def forward(ctx, x, w):
        qx, qw = _fp8(x, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(qx, qw)
        return qx @ qw

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        gx = qg @ qw.t()
        gw = qx.reshape(-1, qx.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        return gx, gw


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _Fp8MM.apply(x, w)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, Dh) at positions 0..T-1: each half-pair (x1, x2)
    rotated by t * theta ** (-i / half)."""
    t, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(w: Dict, p: str, x: torch.Tensor, a: dict, mm: MM):
    b, t, _ = x.shape
    hd, hq, hkv = a["head_dim"], a["n_heads"], a["n_kv_heads"]
    q = rope(mm(x, w[p + "wq"]).view(b, t, hq, hd), a["rope_theta"])
    k = rope(mm(x, w[p + "wk"]).view(b, t, hkv, hd), a["rope_theta"])
    v = mm(x, w[p + "wv"]).view(b, t, hkv, hd)
    k = k.repeat_interleave(hq // hkv, dim=2)
    v = v.repeat_interleave(hq // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return mm(o.reshape(b, t, hq * hd), w[p + "wo"])


def attn_mlp(w: Dict, p: str, x: torch.Tensor, a: dict, mm: MM):
    eps = a["norm_eps"]
    x = x + attention(w, p + "attn/", rmsnorm(x, w[p + "ln1/scale"], eps),
                      a, mm)
    h = rmsnorm(x, w[p + "ln2/scale"], eps)
    h = F.silu(mm(h, w[p + "mlp/w_gate"])) * mm(h, w[p + "mlp/w_up"])
    return x + mm(h, w[p + "mlp/w_down"])


def ssd(c: torch.Tensor, bm: torch.Tensor, v: torch.Tensor,
        la: torch.Tensor, chunk: int) -> torch.Tensor:
    """y_t = sum_{s<=t} exp(sum_{s<u<=t} la_u) (C_t . B_s) v_s.
    c, bm (B, T, N); v (B, T, H, P); la (B, T, H) the log decays."""
    b, t, h, p = v.shape
    n = c.shape[-1]
    state = v.new_zeros((b, h, n, p))
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=v.device).tril()
    ys = []
    for lo in range(0, t, chunk):
        cc, bb, vv = c[:, lo:lo + chunk], bm[:, lo:lo + chunk], v[:, lo:lo + chunk]
        cum = torch.cumsum(la[:, lo:lo + chunk], dim=1)           # (B, c, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]             # (B, i, j, H)
        decay = torch.exp(seg.masked_fill(~causal[None, :, :, None],
                                          float("-inf")))
        scores = torch.einsum("bin,bjn->bij", cc, bb)[..., None] * decay
        y = torch.einsum("bijh,bjhp->bihp", scores, vv)
        y = y + torch.einsum("bin,bhnp->bihp", cc, state) \
            * torch.exp(cum)[..., None]
        tail = torch.exp(cum[:, -1:, :] - cum)                    # (B, c, H)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] \
            + torch.einsum("bjn,bjhp->bhnp", bb, vv * tail[..., None])
        ys.append(y)
    return torch.cat(ys, dim=1)


def mamba2(w: Dict, x: torch.Tensor, a: dict, mm: MM):
    """One Mamba2 layer's output (to be added to ``x``); ``w`` holds the
    layer's leaves, named as under ``blocks/``."""
    b, t, _ = x.shape
    d_inner, heads, n, conv_ch = mamba2_dims(a)
    hp = a["ssm_head_dim"]
    h = rmsnorm(x, w["norm/scale"], a["norm_eps"])
    z, xbc, dt = torch.split(mm(h, w["w_in"]), [d_inner, conv_ch, heads], dim=-1)
    kernel = w["conv/w"].t()[:, None, :]                          # (C, 1, 4)
    xbc = F.silu(F.conv1d(F.pad(xbc.transpose(1, 2), (kernel.shape[-1] - 1, 0)),
                          kernel, groups=conv_ch).transpose(1, 2))
    xv, bm, c = torch.split(xbc, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt + w["dt_bias"])                            # (B, T, H)
    la = -torch.exp(w["a_log"]) * dt
    v = xv.reshape(b, t, heads, hp)
    y = ssd(c, bm, v * dt[..., None], la, min(SSD_CHUNK, t))
    y = (y + v * w["d_skip"][:, None]).reshape(b, t, d_inner)
    y = rmsnorm(y, w["out_norm/scale"], a["norm_eps"]) * F.silu(z)
    return mm(y, w["w_out"])


def layers(w: Dict, prefix: str, depth: int):
    """The stacked leaves under ``prefix`` as per-layer dicts (nested
    ``depth`` deep), each leaf unbound once so that the backward pass
    stacks the layers' gradients in one op."""
    keys = [k for k in w if k.startswith(prefix)]

    def split(cols, d):
        if d == 0:
            return {k[len(prefix):]: c for k, c in zip(keys, cols)}
        return [split(parts, d - 1)
                for parts in zip(*[c.unbind(0) for c in cols])]
    return split([w[k] for k in keys], depth)


def head_loss(w: Dict, a: dict, x: torch.Tensor, labels: torch.Tensor,
              mm: MM) -> torch.Tensor:
    """The final norm, the head (the embedding's transpose where ``w``
    holds no ``unembed``) and the mean cross-entropy over ``labels``."""
    h = rmsnorm(x, w["final_norm/scale"], a["norm_eps"])
    logits = mm(h, w["unembed"] if "unembed" in w else w["embed"].t())
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def loss(w: Dict, a: dict, tokens: torch.Tensor, labels: torch.Tensor,
         mm: MM = matmul) -> torch.Tensor:
    """Mean next-token cross-entropy of f32 weights ``w`` over (B, T)
    ``tokens`` and ``labels``, by the family of ``a``."""
    return families.load(a).loss(w, a, tokens, labels, mm)
