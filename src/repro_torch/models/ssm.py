"""State-space / recurrent blocks: Mamba2 (SSD), mLSTM, sLSTM. The
counterpart of ``repro.models.ssm`` in plain PyTorch.

Mamba2 and mLSTM run through one shared **chunked gated-linear-attention
core** (the SSD block decomposition): intra-chunk work is dense (c x c)
products, and the (N x P) matrix state is carried across the T / c chunks
by a Python loop (the reference's ``lax.scan``). Decode is the O(1)
recurrent step on the same state. mLSTM appends a ones column to its
values, so one pass carries the normaliser too. sLSTM feeds its hidden
state back into its gates, so its prefill is a loop over tokens.

The functions are functional, as in the reference: each returns a new
cache and leaves the one it was given untouched (the stack runner in
:mod:`.transformer` copies the new state into its stacked caches). Their
math follows the reference's dtype casts exactly: the core and the
recurrences in f32, their outputs cast back to the value dtype.

On a mesh, where ``model`` ranks share one part of a train step's rows
(:func:`..dist.sharding.row_share`), each layer takes a
:class:`..dist.sharding.RowShare` and computes its heads' share of the
output, which :func:`..dist.sharding.shard_call` sums over the group:
Mamba2 its heads' z, x and dt columns of ``w_in`` (B and C, read by every
head, whole), conv channels, core and rows of ``w_out``; mLSTM its heads'
xi and z columns of ``w_up`` (xi gathered whole in the group: each head's
q, k and gates read every channel), q, k and gate columns, core and rows
of ``w_down``; both sum ``out_norm``'s mean of squares over the group.
sLSTM splits only its projections by channel and runs its token loop whole
(see :func:`_slstm_cell`). Where the heads do not divide the group, its
ranks split them as far as they divide and the rest compute alike.

One deliberate difference: :func:`gla_chunked` masks the exponent of the
intra-chunk decay before ``exp`` where the reference masks the result. The
forward values are identical; the masked entries above the diagonal, which
overflow to inf for strong decay, can no longer turn a gradient into NaN.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist.sharding import (RowShare, current_mesh, is_dtensor, local_call,
                             meet, shard_map_batch, whole_dim)
from .config import ArchConfig
from .layers import Params, dense_init, normal, rmsnorm, rmsnorm_init


# ---------------------------------------------------------------------------
# shared chunked core:  h_t = a_t h_{t-1} + k_t v_t^T ;  y_t = h_t^T q_t
#   q,k: (B,T,H,N)  v: (B,T,H,P)  a: (B,T,H) in (0,1]
# ---------------------------------------------------------------------------


class GLAState(NamedTuple):
    """The carried matrix state of the core."""

    s: torch.Tensor    # (B, H, N, P) f32


def _cumsum_t(x: torch.Tensor) -> torch.Tensor:
    """``cumsum`` over dim 1 (time). A DTensor's runs on each rank's shard,
    time whole: DTensor in torch 2.11 has no sharding rule for the
    ``flip`` in cumsum's backward."""
    if is_dtensor(x):
        x = whole_dim(x, 1)
        return local_call(lambda t: torch.cumsum(t, dim=1), x.placements, x)
    return torch.cumsum(x, dim=1)


def gla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                a: torch.Tensor, chunk: int,
                init_state: Optional[GLAState] = None
                ) -> Tuple[torch.Tensor, GLAState]:
    """The core over a whole sequence in chunks of ``min(chunk, T)``
    tokens (T must be a multiple of it). Returns (y (B,T,H,P) in ``v``'s
    dtype, the final state)."""
    b, t, h, n = q.shape
    p = v.shape[-1]
    c = min(chunk, t)
    assert t % c == 0, (t, c)
    qf, kf, vf = q.float(), k.float(), v.float()
    la = torch.log(a.clamp_min(1e-20)).float()
    s = (init_state.s if init_state is not None
         else torch.zeros((b, h, n, p), dtype=torch.float32, device=q.device))
    iota = torch.arange(c, device=q.device)
    mask = (iota[:, None] >= iota[None, :])[None, :, :, None]   # (1,c,c,1)
    ys = []
    for lo in range(0, t, c):
        q_i, k_i, v_i = qf[:, lo:lo + c], kf[:, lo:lo + c], vf[:, lo:lo + c]
        cum = _cumsum_t(la[:, lo:lo + c])                    # (B,c,H)
        # intra-chunk: M[i,j] = exp(cum_i - cum_j) for i >= j, masked in
        # the exponent (see the module docstring)
        diff = cum[:, :, None, :] - cum[:, None, :, :]       # (B,c,c,H)
        m = torch.exp(torch.where(mask, diff, -math.inf))
        att = torch.einsum("bihn,bjhn->bijh", q_i, k_i) * m
        y_intra = torch.einsum("bijh,bjhp->bihp", att, v_i)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("bihn,bhnp->bihp", q_i, s) \
            * torch.exp(cum)[..., None]
        # the new carried state
        dec_k = torch.exp(cum[:, -1:, :] - cum)              # decay j -> end
        s_local = torch.einsum("bjhn,bjhp->bhnp", k_i * dec_k[..., None], v_i)
        s = s * torch.exp(cum[:, -1, :])[:, :, None, None] + s_local
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1).to(v.dtype), GLAState(s)


def gla_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             a: torch.Tensor, state: GLAState
             ) -> Tuple[torch.Tensor, GLAState]:
    """Single-token recurrent step. q,k: (B,1,H,N); v: (B,1,H,P); a: (B,1,H).
    A DTensor state stays where it lies: the step's inputs are laid out to
    meet it (its batch, heads, N and P splits)."""
    q, k = (meet(x, state.s, {0: 0, 1: 2, 2: 3}) for x in (q, k))
    v = meet(v, state.s, {0: 0, 1: 2, 3: 3})
    a = meet(a, state.s, {0: 0, 1: 2})
    s = state.s * a[:, 0, :, None, None].float()
    s = s + k[:, 0].float()[..., :, None] * v[:, 0].float()[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", q[:, 0].float(), s)
    return y[:, None].to(v.dtype), GLAState(s)


# ---------------------------------------------------------------------------
# causal depthwise conv (kernel 4), with decode state
# ---------------------------------------------------------------------------

CONV_K = 4


def conv_init(gen, channels: int, dtype, device) -> Params:
    """A (CONV_K, channels) depthwise kernel with std ``1/sqrt(CONV_K)``."""
    return {"w": normal((CONV_K, channels), 1.0 / math.sqrt(CONV_K), dtype,
                        gen, device)}


def conv_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C) causal depthwise conv along T, then SiLU."""
    w = p["w"].float()
    t = x.shape[1]
    xp = F.pad(x.float(), (0, 0, CONV_K - 1, 0))
    out = xp[:, 0:t, :] * w[0]
    for i in range(1, CONV_K):
        out = out + xp[:, i:i + t, :] * w[i]
    return F.silu(out).to(x.dtype)


def conv_step(p: Params, x1: torch.Tensor, state: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x1: (B, 1, C); state: (B, K-1, C) previous inputs (a DTensor state
    stays where it lies: x1 takes its batch and channel splits)."""
    x1 = meet(x1, state, {0: 0, 2: 2})
    w = p["w"].float()
    window = torch.cat([state.float(), x1.float()], dim=1)        # (B,K,C)
    out = torch.einsum("bkc,kc->bc", window, w)[:, None]
    return F.silu(out).to(x1.dtype), window[:, 1:].to(state.dtype)


def recurrent_heads(cfg: ArchConfig) -> dict:
    """``{kind: heads}`` of ``cfg``'s recurrent sub-layers (``mamba2``,
    ``mlstm``, ``slstm``): what a share group splits (:class:`RowShare`);
    empty for a family without them."""
    if cfg.family == "hybrid":
        return {"mamba2": mamba2_dims(cfg)[1]}
    if cfg.family == "ssm":
        kinds = ("mlstm", "slstm") if cfg.xlstm_slstm_every else ("mlstm",)
        return dict.fromkeys(kinds, cfg.n_heads)
    return {}


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


class Mamba2Cache(NamedTuple):
    """A Mamba2 layer's decode state (leading stack axes allowed)."""

    conv: torch.Tensor   # (B, K-1, conv_channels)
    ssd: torch.Tensor    # (B, H, N, P) f32


def mamba2_dims(cfg: ArchConfig):
    """(d_inner, heads, state N, conv channels) of a Mamba2 layer."""
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_ch = d_inner + 2 * n           # x, B, C go through the conv
    return d_inner, heads, n, conv_ch


def mamba2_init(gen, cfg: ArchConfig, dtype, device) -> Params:
    """One Mamba2 layer's params (``a_log``, ``dt_bias``, ``d_skip`` f32)."""
    d = cfg.d_model
    d_inner, heads, n, conv_ch = mamba2_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": rmsnorm_init(d, dtype, device),
        "w_in": dense_init(gen, d, 2 * d_inner + 2 * n + heads, dtype, device),
        "conv": conv_init(gen, conv_ch, dtype, device),
        "a_log": torch.ones((heads,), **f32),            # log(e): A ~ -e
        "dt_bias": torch.zeros((heads,), **f32),
        "d_skip": torch.ones((heads,), **f32),
        "out_norm": rmsnorm_init(d_inner, dtype, device),
        "w_out": dense_init(gen, d_inner, d, dtype, device),
    }


def _mamba2_split(p: Params, x: torch.Tensor, dims):
    d_inner, heads, n = dims
    return torch.split(x @ p["w_in"], [d_inner, d_inner + 2 * n, heads],
                       dim=-1)


def _mamba2_core(p, z, xbc, dt, dims, cfg, b, t):
    d_inner, heads, n = dims
    xv, bb, cc = torch.split(xbc, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                        # (B,T,H)
    a = torch.exp(-torch.exp(p["a_log"]) * dt)                        # decay
    v = xv.reshape(b, t, heads, cfg.ssm_head_dim)
    v_in = v * dt[..., None].to(v.dtype)
    q = cc[:, :, None, :].expand(b, t, heads, n)                      # C
    k = bb[:, :, None, :].expand(b, t, heads, n)                      # B
    return q, k, v, v_in, a


def _mamba2_heads(p: Params, dims, group: RowShare):
    """A Mamba2 layer's params cut to this rank's heads of ``group``, and
    their dims: ``w_in``'s z, x and dt columns of its heads beside the
    B and C columns every head reads, the conv's x channels beside B and
    C, its heads' ``a_log``, ``dt_bias``, ``d_skip``, and its channels of
    ``out_norm`` and rows of ``w_out``."""
    d_inner, heads, n = dims
    ways, k = group.heads(heads)
    di, h = d_inner // ways, heads // ways
    c, hs = slice(k * di, (k + 1) * di), slice(k * h, (k + 1) * h)
    w, conv = p["w_in"], p["conv"]["w"]
    w_in = torch.cat([w[:, c], w[:, d_inner:][:, c],
                      w[:, 2 * d_inner:2 * d_inner + 2 * n],
                      w[:, 2 * d_inner + 2 * n:][:, hs]], dim=1)
    return dict(p, w_in=w_in,
                conv={"w": torch.cat([conv[:, c], conv[:, d_inner:]], 1)},
                a_log=p["a_log"][hs], dt_bias=p["dt_bias"][hs],
                d_skip=p["d_skip"][hs],
                out_norm={"scale": p["out_norm"]["scale"][c]},
                w_out=p["w_out"][c]), (di, h, n)


def _rmsnorm_heads(group: RowShare, width: int, p: Params, x: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """:func:`rmsnorm` over ``width`` channels of which ``x`` holds this
    rank's: the mean of squares sums the group's (one all-gather)."""
    xf = x.float()
    var = group.gather(xf.square().sum(dim=-1, keepdim=True)).sum(0) / width
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def mamba2_apply(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 cache: Optional[Mamba2Cache] = None,
                 group: Optional[RowShare] = None
                 ) -> Tuple[torch.Tensor, Optional[Mamba2Cache]]:
    """x (B,T,D) -> (the layer's output, to be added to x; the new cache).
    With a cache and T == 1 the recurrent step, else the chunked SSD. With
    ``group`` (no cache) this rank's heads of it, and its share of the
    output."""
    b, t, _ = x.shape
    d_inner, heads, n, _ = mamba2_dims(cfg)
    dims, out_norm = (d_inner, heads, n), rmsnorm
    if group is not None:
        p, dims = _mamba2_heads(p, dims, group)
        out_norm = functools.partial(_rmsnorm_heads, group, d_inner)
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    z, xbc, dt = _mamba2_split(p, xn, dims)
    if cache is not None and t == 1:           # decode: O(1) recurrent step
        xbc1, conv_state = conv_step(p["conv"], xbc, cache.conv)
        q, k, v, v_in, a = _mamba2_core(p, z, xbc1, dt, dims, cfg, b, t)
        y, st = gla_step(q, k, v_in, a, GLAState(cache.ssd))
        new_cache = Mamba2Cache(conv=conv_state, ssd=st.s)
    else:                                       # train / prefill: chunked SSD
        xbc_raw = xbc
        xbc = conv_apply(p["conv"], xbc)
        q, k, v, v_in, a = _mamba2_core(p, z, xbc, dt, dims, cfg, b, t)
        init = GLAState(cache.ssd) if cache is not None else None
        y, st = gla_chunked(q, k, v_in, a, cfg.ssm_chunk, init_state=init)
        new_cache = None
        if cache is not None:
            tail = torch.cat([cache.conv.to(xbc_raw.dtype), xbc_raw],
                             dim=1)[:, -(CONV_K - 1):]
            new_cache = Mamba2Cache(conv=tail.to(cache.conv.dtype), ssd=st.s)
    y = y + v * p["d_skip"][None, None, :, None].to(v.dtype)
    y = y.reshape(b, t, dims[0])
    y = out_norm(p["out_norm"], y, cfg.norm_eps) * F.silu(z)
    return (y @ p["w_out"]).to(x.dtype), new_cache


def mamba2_cache_init(cfg: ArchConfig, batch: int, dtype, device,
                      lead: Tuple[int, ...] = ()) -> Mamba2Cache:
    """A zero Mamba2 cache, with the leading stack axes ``lead``."""
    d_inner, heads, n, conv_ch = mamba2_dims(cfg)
    return Mamba2Cache(
        conv=torch.zeros(lead + (batch, CONV_K - 1, conv_ch), dtype=dtype,
                         device=device),
        ssd=torch.zeros(lead + (batch, heads, n, cfg.ssm_head_dim),
                        dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): matrix memory via the shared core + normaliser column
# ---------------------------------------------------------------------------


class MLSTMCache(NamedTuple):
    """An mLSTM layer's decode state (leading stack axes allowed)."""

    s: torch.Tensor    # (B, H, N, P+1) f32, the normaliser in the last column


def mlstm_dims(cfg: ArchConfig):
    """(d_inner, heads, q/k head dim N, value head dim P) of an mLSTM layer."""
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.n_heads
    p = d_inner // heads
    n = max(cfg.hd, 16)
    return d_inner, heads, n, p


def mlstm_init(gen, cfg: ArchConfig, dtype, device) -> Params:
    """One mLSTM layer's params."""
    d = cfg.d_model
    d_inner, heads, n, pdim = mlstm_dims(cfg)
    return {
        "norm": rmsnorm_init(d, dtype, device),
        "w_up": dense_init(gen, d, 2 * d_inner, dtype, device),
        "w_q": dense_init(gen, d_inner, heads * n, dtype, device),
        "w_k": dense_init(gen, d_inner, heads * n, dtype, device),
        "w_if": dense_init(gen, d_inner, 2 * heads, dtype, device),
        "out_norm": rmsnorm_init(d_inner, dtype, device),
        "w_down": dense_init(gen, d_inner, d, dtype, device),
    }


def _mlstm_qkv(p, xi, xv, dims, b, t):
    d_inner, heads, n, pdim = dims
    q = (xi @ p["w_q"]).reshape(b, t, heads, n) / math.sqrt(n)
    k = (xi @ p["w_k"]).reshape(b, t, heads, n) / math.sqrt(n)
    v = xv.reshape(b, t, heads, pdim)
    gates = (xi @ p["w_if"]).float().reshape(b, t, heads, 2)
    i_g = torch.sigmoid(gates[..., 0])
    f_g = torch.sigmoid(gates[..., 1] + 2.0)    # bias toward remember
    i_v = i_g[..., None].to(v.dtype)
    ones = torch.ones((b, t, heads, 1), dtype=v.dtype, device=v.device)
    v_aug = torch.cat([v * i_v, ones * i_v], dim=-1)
    return q, k, v_aug, f_g


def _mlstm_out(y_aug, z, p, cfg, b, t, dims, norm=rmsnorm):
    d_inner, heads, n, pdim = dims
    y, norm_col = y_aug[..., :pdim], y_aug[..., pdim:]
    y = y / norm_col.abs().clamp_min(1.0)
    y = y.reshape(b, t, d_inner)
    y = norm(p["out_norm"], y, cfg.norm_eps) * F.silu(z)
    return y @ p["w_down"]


def _mlstm_heads(p: Params, xn: torch.Tensor, cfg: ArchConfig,
                 group: RowShare) -> torch.Tensor:
    """The train-time mLSTM on this rank's heads of ``group``: from
    ``w_up`` its heads' xi and z columns only; xi gathered whole in the
    group (each head's q, k and gates read every channel); its heads'
    ``w_q``, ``w_k`` and ``w_if`` columns, core and ``out_norm`` channels
    (the mean of squares summed over the group), its rows of ``w_down``:
    its share of the output."""
    b, t, _ = xn.shape
    d_inner, heads, n, pdim = mlstm_dims(cfg)
    ways, k = group.heads(heads)
    di, h = d_inner // ways, heads // ways
    c, hn = slice(k * di, (k + 1) * di), slice(k * h * n, (k + 1) * h * n)
    w = p["w_up"]
    xi, z = torch.split(xn @ torch.cat([w[:, c], w[:, d_inner:][:, c]], 1),
                        di, dim=-1)
    whole = group.gather(xi).movedim(0, -2).flatten(-2)       # (B,T,d_inner)
    p = dict(p, w_q=p["w_q"][:, hn], w_k=p["w_k"][:, hn],
             w_if=p["w_if"][:, 2 * k * h:2 * (k + 1) * h],
             out_norm={"scale": p["out_norm"]["scale"][c]},
             w_down=p["w_down"][c])
    dims = (di, h, n, pdim)
    q, kk, v_aug, f_g = _mlstm_qkv(p, whole, xi, dims, b, t)
    y_aug, _ = gla_chunked(q, kk, v_aug, f_g, cfg.ssm_chunk)
    return _mlstm_out(y_aug, z, p, cfg, b, t, dims,
                      functools.partial(_rmsnorm_heads, group, d_inner))


def mlstm_apply(p: Params, x: torch.Tensor, cfg: ArchConfig,
                cache: Optional[MLSTMCache] = None,
                group: Optional[RowShare] = None
                ) -> Tuple[torch.Tensor, Optional[MLSTMCache]]:
    """x (B,T,D) -> (the layer's output, to be added to x; the new cache).
    With a cache and T == 1 the recurrent step, else the chunked core.
    With ``group`` (no cache) this rank's heads of it, and its share of
    the output."""
    b, t, _ = x.shape
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    if group is not None:
        return _mlstm_heads(p, xn, cfg, group).to(x.dtype), None
    xi, z = torch.chunk(xn @ p["w_up"], 2, dim=-1)
    dims = mlstm_dims(cfg)
    q, k, v_aug, f_g = _mlstm_qkv(p, xi, xi, dims, b, t)
    if cache is not None and t == 1:           # decode
        y_aug, st = gla_step(q, k, v_aug, f_g, GLAState(cache.s))
        new_cache = MLSTMCache(st.s)
    else:                                       # train / prefill
        init = GLAState(cache.s) if cache is not None else None
        y_aug, st = gla_chunked(q, k, v_aug, f_g, cfg.ssm_chunk,
                                init_state=init)
        new_cache = MLSTMCache(st.s) if cache is not None else None
    return _mlstm_out(y_aug, z, p, cfg, b, t, dims).to(x.dtype), new_cache


def mlstm_cache_init(cfg: ArchConfig, batch: int, device,
                     lead: Tuple[int, ...] = ()) -> MLSTMCache:
    """A zero mLSTM cache, with the leading stack axes ``lead``."""
    d_inner, heads, n, pdim = mlstm_dims(cfg)
    return MLSTMCache(torch.zeros(lead + (batch, heads, n, pdim + 1),
                                  dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# sLSTM block: a loop over tokens (hidden-state feedback in the gates)
# ---------------------------------------------------------------------------


class SLSTMCache(NamedTuple):
    """An sLSTM layer's state (leading stack axes allowed), all f32."""

    c: torch.Tensor   # (B, d_inner)
    n: torch.Tensor   # (B, d_inner)
    h: torch.Tensor   # (B, d_inner)


def slstm_init(gen, cfg: ArchConfig, dtype, device) -> Params:
    """One sLSTM layer's params; ``r`` is the per-head recurrent matrix."""
    d = cfg.d_model
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.n_heads
    dh = d_inner // heads
    return {
        "norm": rmsnorm_init(d, dtype, device),
        "w_in": dense_init(gen, d, 4 * d_inner, dtype, device),   # z,i,f,o
        "r": normal((heads, dh, 4 * dh), 1.0 / math.sqrt(dh), dtype, gen,
                    device),
        "out_norm": rmsnorm_init(d_inner, dtype, device),
        "w_out": dense_init(gen, d_inner, d, dtype, device),
    }


def _slstm_cell(p, cfg, pre, state: SLSTMCache
                ) -> Tuple[torch.Tensor, SLSTMCache]:
    """pre: (B, 4*d_inner) input pre-activations for one step."""
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.n_heads
    dh = d_inner // heads
    b = pre.shape[0]
    # the heads' recurrence reads each head's whole h: a state split on its
    # channels over a mesh is gathered there (B x d_inner f32)
    hh = whole_dim(state.h, 1).reshape(b, heads, dh)
    # head h's 4 dh outputs lie side by side, so chunk g of z, i, f, o
    # below is head g's recurrence over every channel (with 4 heads): every
    # channel's gates read every head's state, and the loop cannot split by
    # head. A rank that shares a row's heads runs it whole (slstm_apply).
    rec = torch.einsum("bhd,hdg->bhg", hh.float(),
                       p["r"].float()).reshape(b, 4 * d_inner)
    z, i, f, o = torch.chunk(pre.float() + rec, 4, dim=-1)
    z = torch.tanh(z)
    i = torch.exp(i.clamp_max(10.0))
    f = torch.sigmoid(f + 2.0)
    o = torch.sigmoid(o)
    c = f * state.c + i * z
    n = f * state.n + i
    h = o * c / n.abs().clamp_min(1.0)
    return h, SLSTMCache(c=c, n=n, h=h)


def _slstm_scan(p, cfg, pre, state: SLSTMCache
                ) -> Tuple[torch.Tensor, SLSTMCache]:
    """The cell over every token of ``pre`` (B, T, 4*d_inner): (h of each
    token (B, T, d_inner), the last state)."""
    hs = []
    for s in range(pre.shape[1]):
        h, state = _slstm_cell(p, cfg, pre[:, s], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def slstm_apply(p: Params, x: torch.Tensor, cfg: ArchConfig,
                cache: Optional[SLSTMCache] = None,
                group: Optional[RowShare] = None
                ) -> Tuple[torch.Tensor, Optional[SLSTMCache]]:
    """x (B,T,D) -> (the layer's output, to be added to x; the new cache,
    None without one): one cell per token. With ``group`` (no cache) this
    rank's channels of z, i, f and o from ``w_in``, gathered whole in the
    group before the loop, which runs whole, and its rows of ``w_out``:
    its share of the output."""
    b, t, _ = x.shape
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    if group is None:
        pre = xn @ p["w_in"]                               # (B,T,4*d_inner)
    else:
        d_inner = cfg.ssm_expand * cfg.d_model
        ways, k = group.heads(cfg.n_heads)
        di = d_inner // ways
        c = slice(k * di, (k + 1) * di)
        w = p["w_in"].unflatten(1, (4, d_inner))[:, :, c].flatten(1)
        pre = group.gather((xn @ w).unflatten(-1, (4, di)))
        pre = pre.permute(1, 2, 3, 0, 4).flatten(2)        # (B,T,4*d_inner)
    state = cache if cache is not None else slstm_cache_init(cfg, b, x.device)
    p = dict(p, r=p["r"].float())        # cast once, not at every token
    if t == 1:
        h, state = _slstm_cell(p, cfg, pre[:, 0], state)
        hs = h[:, None]
    elif current_mesh() is None:
        hs, state = _slstm_scan(p, cfg, pre, state)
    else:
        # the token loop on each rank's rows as plain tensors: thousands of
        # small ops, each of which DTensor would dispatch (minutes a layer)
        hs, state = shard_map_batch(
            lambda pre, c, n, h, r: _slstm_scan(
                dict(p, r=r), cfg, pre, SLSTMCache(c, n, h)),
            pre, *state, whole=(p["r"],))
    y = rmsnorm(p["out_norm"], hs.to(x.dtype), cfg.norm_eps)
    out = y @ p["w_out"] if group is None else y[..., c] @ p["w_out"][c]
    return out.to(x.dtype), (state if cache is not None else None)


def slstm_cache_init(cfg: ArchConfig, batch: int, device,
                     lead: Tuple[int, ...] = ()) -> SLSTMCache:
    """A zero sLSTM state, with the leading stack axes ``lead``."""
    shape = lead + (batch, cfg.ssm_expand * cfg.d_model)
    return SLSTMCache(*(torch.zeros(shape, dtype=torch.float32, device=device)
                        for _ in range(3)))
