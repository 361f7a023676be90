"""LM assembly for all ten architectures, the counterpart of
``repro.models.transformer`` in plain PyTorch.

Depth is organised in *super-blocks*, as in the reference:

  dense/moe     : n_layers super-blocks of 1 layer (attn + MLP/MoE)
  vlm           : 1 cross-attn layer + (every - 1) self layers per super-block
  hybrid/zamba2 : 1 *shared* attention block (params hoisted out of the
                  stack, one KV cache per application) + every Mamba2
  ssm/xlstm     : (every - 1) mLSTM + 1 sLSTM per super-block
  audio/whisper : a bidirectional encoder, then decoder layers of
                  self-attn + cross-attn + MLP

Params are nested dicts of tensors in the reference's layout: every leaf
of a stack carries the reference's leading axes, (n_super,) or (n_super,
per) (the reference scans over them), and the runner is a Python loop over
views of those stacked tensors. So a param tree is the same set of leaves,
names and shapes in both packages and a stored table loads into either.
Caches keep the same stacking and are written in place: a KV cache is a
:class:`KVCache` of (n_super[, per], B, S, Hkv, Dh) tensors, an SSM state
the :mod:`.ssm` NamedTuple of its stacked tensors, and ``caches["index"]``
the per-slot lengths (B,).

There is no scan. While autograd records, each super-block of the main
stack and each encoder layer runs under ``torch.utils.checkpoint`` with
the policy ``cfg.remat_policy`` names, as the reference wraps them in
``jax.checkpoint``: ``nothing_saveable`` (the default) keeps only each
super-block's input and recomputes the rest in the backward pass;
``dots_saveable`` also keeps the outputs of every matmul (``mm``,
``addmm``, ``bmm``, ``baddbmm``), ``dots_with_no_batch_dims_saveable``
those of the unbatched ones; ``everything_saveable`` does not
rematerialise. The cross-entropy's chunks are recomputed too
(:func:`loss_fn`).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import obs
from ..dist.sharding import (constrain, entering, in_stream, per_op,
                             rejoin, shard_call, stream, use_weight,
                             whole_dim)
from ..tree import leaves, rebuild, tree_map
from . import ssm
from .attention import Index, KVCache, attn_apply, attn_init, init_kv_cache
from .config import ArchConfig
from .layers import (Params, dense_init, dtype_of, embed, embed_init, mlp,
                     mlp_init, rmsnorm, rmsnorm_init, unembed)
from .moe import moe_apply, moe_init


def _stack(trees):
    """One tree whose leaves are the stacked leaves of ``trees``."""
    cols = zip(*[[leaf for _, leaf in leaves(t)] for t in trees])
    return rebuild(trees[0], iter([torch.stack(c) for c in cols]))


def _at(tree, *idx):
    """``tree`` with every leaf indexed by ``idx`` (views). A cache split
    over a mesh on one of those stacked axes would give gathered copies,
    which a write would not reach: that raises."""
    def view(v):
        if any(getattr(p, "dim", len(idx)) < len(idx)
               for p in getattr(v, "placements", ())):
            raise ValueError(f"a cache leaf {tuple(v.shape)} split over the "
                             f"mesh on a stacked layer axis ({v.placements}) "
                             f"has no per-layer view to write into")
        return v[idx]
    return tree_map(view, tree)


def _unstack(tree, depth: int = 1):
    """``tree``'s layers along its leaves' first ``depth`` stacked axes: a
    nested list of trees of views. Each leaf is unbound once, so the
    backward pass stacks the layers' gradients in one op; indexing each
    layer instead would add a zero-padded copy of the whole stacked leaf
    per layer. A layer axis split over a mesh is gathered first."""
    flat = leaves(tree)
    cols = [whole_dim(v, 0).unbind(0) for _, v in flat]
    out = [rebuild(tree, iter([c[i] for c in cols]))
           for i in range(flat[0][1].shape[0])]
    return out if depth == 1 else [_unstack(t, depth - 1) for t in out]


# ---------------------------------------------------------------------------
# super-block geometry
# ---------------------------------------------------------------------------


def superblock_plan(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_super, layers_per_super) for the main stack."""
    every = {"vlm": cfg.cross_attn_every, "hybrid": cfg.shared_attn_every,
             "ssm": cfg.xlstm_slstm_every}.get(cfg.family, 0)
    if not every:
        return cfg.n_layers, 1
    if cfg.n_layers % every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a "
                         f"multiple of the super-block's {every}")
    return cfg.n_layers // every, every


# ---------------------------------------------------------------------------
# per-family layer init
# ---------------------------------------------------------------------------


def _attn_mlp_layer_init(gen, cfg: ArchConfig, dtype, device,
                         use_moe: bool, cross: bool = False) -> Params:
    p: Params = {"ln1": rmsnorm_init(cfg.d_model, dtype, device),
                 "attn": attn_init(gen, cfg, dtype, device),
                 "ln2": rmsnorm_init(cfg.d_model, dtype, device)}
    if use_moe:
        p["moe"] = moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    if cross:
        p["ln_cross"] = rmsnorm_init(cfg.d_model, dtype, device)
        p["cross"] = attn_init(gen, cfg, dtype, device)
    return p


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator] = None, *,
                device: Any = "cuda") -> Params:
    """Random params drawn from ``gen`` on ``device`` (``"meta"`` gives a
    template of shapes and dtypes for :meth:`ModelRepo.load`)."""
    dtype = dtype_of(cfg.dtype)
    params: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype, device)
    n_super, per = superblock_plan(cfg)
    fam = cfg.family

    def stack(fn, n):
        return _stack([fn() for _ in range(n)])

    def attn_mlp(**kw):
        return _attn_mlp_layer_init(gen, cfg, dtype, device,
                                    use_moe=fam == "moe", **kw)

    def layer(init):
        return lambda: init(gen, cfg, dtype, device)

    if fam in ("dense", "moe"):
        params["blocks"] = stack(attn_mlp, n_super)
    elif fam == "vlm":
        params["cross_blocks"] = stack(lambda: attn_mlp(cross=True), n_super)
        params["blocks"] = stack(lambda: stack(attn_mlp, per - 1), n_super)
    elif fam == "hybrid":
        params["shared_attn"] = attn_mlp()
        params["blocks"] = stack(lambda: stack(layer(ssm.mamba2_init), per),
                                 n_super)
    elif fam == "ssm" and cfg.xlstm_slstm_every:
        params["blocks"] = stack(lambda: stack(layer(ssm.mlstm_init), per - 1),
                                 n_super)
        params["slstm_blocks"] = stack(layer(ssm.slstm_init), n_super)
    elif fam == "ssm":
        params["blocks"] = stack(layer(ssm.mlstm_init), n_super)
    elif fam == "audio":
        params["enc_blocks"] = stack(attn_mlp, cfg.n_encoder_layers)
        params["enc_norm"] = rmsnorm_init(cfg.d_model, dtype, device)
        params["blocks"] = stack(lambda: attn_mlp(cross=True), n_super)
    else:
        raise ValueError(f"unknown family {fam}")
    return params


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                enc_len: int = 1, device: Any = "cuda") -> Dict[str, Any]:
    """Zero caches for ``batch`` slots of ``max_len`` positions (and, for
    the audio family, an ``enc_out`` of ``enc_len`` encoder states)."""
    dtype = dtype_of(cfg.dtype)
    n_super, per = superblock_plan(cfg)
    fam = cfg.family

    def kv(*lead):
        return init_kv_cache(cfg, batch, max_len, dtype, device, lead=lead)

    caches: Dict[str, Any] = {
        "index": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if fam in ("dense", "moe", "audio"):
        caches["blocks"] = kv(n_super)
    elif fam == "vlm":
        caches["cross_blocks"] = kv(n_super)
        caches["blocks"] = kv(n_super, per - 1)
    elif fam == "hybrid":
        caches["shared_attn"] = kv(n_super)
        caches["blocks"] = ssm.mamba2_cache_init(cfg, batch, dtype, device,
                                                 lead=(n_super, per))
    elif fam == "ssm" and cfg.xlstm_slstm_every:
        caches["blocks"] = ssm.mlstm_cache_init(cfg, batch, device,
                                                lead=(n_super, per - 1))
        caches["slstm_blocks"] = ssm.slstm_cache_init(cfg, batch, device,
                                                      lead=(n_super,))
    elif fam == "ssm":
        caches["blocks"] = ssm.mlstm_cache_init(cfg, batch, device,
                                                lead=(n_super,))
    else:
        raise ValueError(f"unknown family {fam}")
    if fam == "audio":
        caches["enc_out"] = torch.zeros((batch, enc_len, cfg.d_model),
                                        dtype=dtype, device=device)
    return caches


# ---------------------------------------------------------------------------
# layer application and the stack runner
# ---------------------------------------------------------------------------


def _apply_attn_mlp(pl: Params, x, cfg: ArchConfig, positions, *,
                    use_moe: bool, causal: bool = True, window=None,
                    cache: Optional[KVCache] = None, cache_index=None,
                    cross_kv: Optional[torch.Tensor] = None):
    h, _ = attn_apply(pl["attn"], rmsnorm(pl["ln1"], x, cfg.norm_eps), cfg,
                      positions=positions, causal=causal, window=window,
                      cache=cache, cache_index=cache_index)
    x = x + rejoin(x, h)
    if cross_kv is not None:
        hc, _ = attn_apply(pl["cross"], rmsnorm(pl["ln_cross"], x,
                                                cfg.norm_eps),
                           cfg, positions=positions, kv_x=cross_kv,
                           causal=False, use_rope=False)
        x = x + rejoin(x, hc)
    if use_moe:
        xo = per_op(x)
        h2, aux = moe_apply(pl["moe"], rmsnorm(pl["ln2"], xo, cfg.norm_eps),
                            cfg)
        return rejoin(x, xo + h2), aux
    h2 = mlp(pl["mlp"], rmsnorm(pl["ln2"], x, cfg.norm_eps))
    return x + rejoin(x, h2), torch.zeros((), dtype=torch.float32,
                                          device=x.device)


# the reference's jax.checkpoint policies: which outputs a rematerialised
# super-block keeps for the backward pass (None: every matmul is recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
REMAT_POLICIES = {
    "nothing_saveable": None,
    "dots_saveable": _DOTS + _BATCHED_DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS,
    "everything_saveable": None,
}


def _saving(ops):
    """A selective-checkpoint policy that keeps the outputs of ``ops``."""
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


def _direct(fn, *args):
    return fn(*args)


def _rematerialiser(cfg: ArchConfig, tree: Params, x: torch.Tensor):
    """``call(fn, *args)``: ``fn(*args)`` under ``cfg.remat_policy``, as the
    reference wraps each super-block in ``jax.checkpoint``. The wrapper is
    only put on while autograd records a graph through ``x`` or a leaf of
    ``tree``, so prefill and decode run plain and write their caches in
    place; ``everything_saveable`` never puts it on."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; have "
                         f"{sorted(REMAT_POLICIES)}")
    saved = REMAT_POLICIES[cfg.remat_policy]
    if (cfg.remat_policy == "everything_saveable"
            or not torch.is_grad_enabled()
            or not (x.requires_grad
                    or any(t.requires_grad for _, t in leaves(tree)))):
        return _direct
    kw = {"context_fn": _saving(saved)} if saved else {}
    return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _run_stack(params: Params, cfg: ArchConfig, x: torch.Tensor, positions,
               *, caches: Optional[Dict[str, Any]], cache_index,
               cross_kv: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The main stack over ``x`` (B, T, D): (x', aux). Caches are written
    in place. Without caches each super-block is rematerialised under
    ``cfg.remat_policy``; zamba2's shared attention params, used by every
    super-block, collect their gradient over all recomputed applications."""
    fam = cfg.family
    n_super, per = superblock_plan(cfg)
    use_cache = caches is not None
    call = _direct if use_cache else _rematerialiser(cfg, params, x)

    nested = fam in ("vlm", "hybrid") or (fam == "ssm"
                                          and bool(cfg.xlstm_slstm_every))
    layers = {k: _unstack(params[k], 2 if k == "blocks" and nested else 1)
              for k in ("blocks", "cross_blocks", "slstm_blocks")
              if k in params}

    def cache_at(key, *idx):
        return _at(caches[key], *idx) if use_cache else None

    def attn_mlp(pl, x, cache, **kw):
        return _apply_attn_mlp(pl, x, cfg, positions, use_moe=False,
                               cache=cache, cache_index=cache_index, **kw)[0]

    def recurrent(apply, pl, x, cache):
        if in_stream(x):
            # the plain layer on each rank's rows (or its share of their
            # heads, where ranks share them), its weights whole
            flat = [use_weight(w, None) for _, w in leaves(pl)]
            xr = entering(x, rows=True)
            dx = shard_call(
                lambda group, xl, *ws: apply(rebuild(pl, iter(ws)), xl, cfg,
                                             group=group)[0],
                xr.placements, xr, *flat, rows=True)
            return x + rejoin(x, dx)
        dx, new = apply(pl, x, cfg, cache=cache)
        if cache is not None:   # the new state into the stacked views
            for view, leaf in zip(cache, new):
                view.copy_(leaf)
        return x + dx

    def super_block(x, i):
        """Super-block ``i`` over ``x``: (x', its aux loss or None), in a
        span that a checkpoint's recompute opens again inside the backward
        pass."""
        with obs.span("model.superblock"):
            return block(x, i)

    def block(x, i):
        if fam in ("dense", "moe"):
            cache = None
            if use_cache:
                cache = cache_at("blocks", i)
            return _apply_attn_mlp(layers["blocks"][i], x, cfg,
                                   positions, use_moe=fam == "moe",
                                   window=cfg.window, cache=cache,
                                   cache_index=cache_index)
        if fam == "vlm":
            x = attn_mlp(layers["cross_blocks"][i], x,
                         cache_at("cross_blocks", i), cross_kv=cross_kv)
            for j in range(per - 1):
                x = attn_mlp(layers["blocks"][i][j], x,
                             cache_at("blocks", i, j))
        elif fam == "hybrid":
            x = attn_mlp(params["shared_attn"], x, cache_at("shared_attn", i))
            for j in range(per):
                x = recurrent(ssm.mamba2_apply, layers["blocks"][i][j],
                              x, cache_at("blocks", i, j))
        elif fam == "ssm" and cfg.xlstm_slstm_every:
            for j in range(per - 1):
                x = recurrent(ssm.mlstm_apply, layers["blocks"][i][j],
                              x, cache_at("blocks", i, j))
            x = recurrent(ssm.slstm_apply, layers["slstm_blocks"][i], x,
                          cache_at("slstm_blocks", i))
        elif fam == "ssm":
            x = recurrent(ssm.mlstm_apply, layers["blocks"][i], x,
                          cache_at("blocks", i))
        elif fam == "audio":
            x = attn_mlp(layers["blocks"][i], x, cache_at("blocks", i),
                         cross_kv=cross_kv)
        else:
            raise ValueError(f"unknown family {fam}")
        return x, None

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_super):
        x, a = call(super_block, x, i)
        if a is not None:
            aux = aux + a
    return x, aux


def _encode(params: Params, cfg: ArchConfig, frames: torch.Tensor, *,
            remat: bool = True) -> torch.Tensor:
    """frames (B, T_enc, D), the stub frontend's embeddings -> the encoder's
    states after ``enc_norm`` (bidirectional self-attention layers, each
    rematerialised under ``cfg.remat_policy`` while autograd records, unless
    ``remat`` is false, as in a prefill; a call with remat lays the frames
    out as the residual stream)."""
    x = stream(frames) if remat else frames
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    call = _rematerialiser(cfg, params["enc_blocks"], x) if remat else _direct
    enc = _unstack(params["enc_blocks"])

    def layer(x, l):
        return _apply_attn_mlp(enc[l], x, cfg, positions, use_moe=False,
                               causal=False)[0]

    for l in range(cfg.n_encoder_layers):
        x = call(layer, x, l)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _backbone(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
              image_embeds: Optional[torch.Tensor] = None,
              encoder_frames: Optional[torch.Tensor] = None,
              caches: Optional[Dict[str, Any]] = None,
              cache_index: Optional[Index] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """tokens (B, T) -> (hidden (B, T, D) after the final norm, caches',
    aux). ``image_embeds`` (vlm) and ``encoder_frames`` (audio) are the stub
    frontends' outputs, (B, n, D) each. An audio call with caches and no
    frames reads the encoder states from ``caches["enc_out"]``; one with
    frames encodes them and stores the result there."""
    x = embed(params["embed"], tokens)
    if caches is None:
        # a step that writes no cache lays its stream out once, Megatron's
        # way; a cache's prefill and decode keep it as the embedding gives it
        x = stream(x)
    t = tokens.shape[1]
    steps = torch.arange(t, device=tokens.device)
    base = cache_index if cache_index is not None else 0
    if isinstance(base, torch.Tensor) and base.ndim == 1:
        positions = base[:, None].long() + steps[None, :]  # per slot
    else:
        positions = (int(base) + steps).expand(tokens.shape)
    positions = constrain(positions, ["batch", None])   # as the tokens
    cross_kv = None
    if cfg.family == "vlm":
        if image_embeds is None:
            raise ValueError("the vlm family needs image_embeds (stub frontend)")
        cross_kv = image_embeds
    elif cfg.family == "audio":
        if caches is not None and encoder_frames is None:
            cross_kv = caches["enc_out"]
        elif encoder_frames is None:
            raise ValueError("the audio family needs encoder_frames (stub "
                             "frontend) or caches holding enc_out")
        else:
            cross_kv = _encode(params, cfg, encoder_frames,
                               remat=caches is None)
            if caches is not None:
                caches = dict(caches, enc_out=cross_kv)
    x, aux = _run_stack(params, cfg, x, positions, caches=caches,
                        cache_index=cache_index, cross_kv=cross_kv)
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    new_caches = caches
    if caches is not None and cache_index is not None:
        nxt = cache_index + t
        if not isinstance(nxt, torch.Tensor) or nxt.ndim == 0:
            nxt = torch.full((tokens.shape[0],), int(nxt), dtype=torch.int32,
                             device=tokens.device)
        new_caches = dict(caches, index=nxt.to(torch.int32))
    return h, new_caches, aux


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            last_logits_only: bool = False, **kw
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """tokens (B, T) -> (logits (B, T, V) f32, caches', aux loss); ``kw``:
    ``caches`` and ``cache_index`` (see :func:`prefill`,
    :func:`decode_step`), ``image_embeds`` / ``encoder_frames``. With
    ``last_logits_only`` the logits are (B, 1, V), the last position's."""
    h, new_caches, aux = _backbone(params, cfg, tokens, **kw)
    if last_logits_only:
        h = h[:, -1:]
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed(table, h, tied=cfg.tie_embeddings), new_caches, aux


CE_CHUNK = 1024
CE_TILE_BYTES = 4 << 30   # the most f32 logits one chunk makes, at global shape


def _ce_chunk(table: torch.Tensor, h_c: torch.Tensor, l_c: torch.Tensor,
              tied: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked NLL, count of labels >= 0) of one chunk."""
    w = table.t() if tied else table
    logits = h_c.float() @ w.float()                     # (B, c, V) f32
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, l_c.clamp_min(0)[..., None].long())[..., 0]
    mask = (l_c >= 0).float()
    return (nll * mask).sum(), mask.sum()


def _ce_sums(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
             tied: bool, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked NLL, count of labels >= 0) over (B, T) ``h``
    and ``labels``, ``c`` positions at a time, each chunk recomputed in the
    backward pass."""
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, h.shape[1], c):
        n, m = checkpoint(_ce_chunk, table, h[:, s:s + c], labels[:, s:s + c],
                          tied, use_reentrant=False)
        tot, cnt = tot + n, cnt + m
    return tot, cnt


def _chunked_ce(h: torch.Tensor, table: torch.Tensor, tied: bool,
                labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the labels >= 0, without materialising
    (B, T, V) logits: one (B, ``CE_CHUNK``, V) f32 tile of sequence positions
    at a time, recomputed in the backward pass (the reference's
    ``jax.checkpoint`` chunk body). A chunk has fewer positions where its
    logits would pass ``CE_TILE_BYTES`` (a train_4k batch of 256 rows: 256
    x 1024 x 51,865 f32 is 54 GB). The last chunk is ragged where the
    reference pads it with masked positions, which add nothing. Over the
    stream on a mesh each rank takes its rows' share of the positions over
    ``model`` (a slice of what it holds) against the whole table, and the
    two sums are reduced once; otherwise the table is gathered whole once,
    not once a chunk."""
    v = table.shape[0] if tied else table.shape[1]
    c = max(1, min(CE_CHUNK, h.shape[1],
                   CE_TILE_BYTES // (4 * h.shape[0] * v)))
    if not in_stream(h):
        # outside a mesh, or a stream left as the embedding laid it out
        tot, cnt = _ce_sums(h, constrain(table, [None, None]), labels, tied,
                            c)
    else:
        from torch.distributed.tensor import Partial
        labels = constrain(labels, ["batch", "model"])    # as h's rows
        out = tuple(Partial() if p.is_shard() else p for p in h.placements)
        tot, cnt = shard_call(
            lambda _, *a: _ce_sums(*a, tied=tied, c=c), out, h,
            use_weight(table, None), labels)
    return tot / cnt.clamp_min(1.0)


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``batch`` {"tokens", "labels"} (B, T), labels -1 where masked, and
    the vlm's ``image_embeds`` / the audio family's ``encoder_frames`` ->
    (total = loss + 0.01 aux, {"loss", "aux"})."""
    h, _, aux = _backbone(params, cfg, batch["tokens"],
                          image_embeds=batch.get("image_embeds"),
                          encoder_frames=batch.get("encoder_frames"))
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    with obs.span("train.loss"):
        # the backward pass from the loss's gradient to h's in a span too
        h, mark = obs.backward_span("train.loss.backward", h)
        loss = mark(_chunked_ce(h, table, cfg.tie_embeddings, batch["labels"]))
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def prefill(params, cfg, tokens, caches, *, last_logits_only: bool = False,
            **kw):
    """Fill empty ``caches`` with ``tokens`` (B, T) from position 0; ``kw``:
    the frontends' ``image_embeds`` / ``encoder_frames``."""
    return forward(params, cfg, tokens, caches=caches, cache_index=0,
                   last_logits_only=last_logits_only, **kw)


def decode_step(params, cfg, token, caches, **kw):
    """token: (B, 1); the caches carry their own per-slot index; ``kw`` as
    for :func:`prefill`."""
    return forward(params, cfg, token, caches=caches,
                   cache_index=caches["index"], **kw)


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
