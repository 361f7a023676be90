"""The four shape cells and, per (arch x cell), the function to run, its
inputs and their shardings: the port of ``repro.launch.specs``.

Where the reference builds abstract inputs (``ShapeDtypeStruct``) for jit
to lower, :func:`make_cell` builds each input as DTensors laid out by its
sharding: on ``"meta"`` (shapes only: what the meta dry run and the tests
use), or on a device, where each rank holds only its own shards, filled
from a seeded generator (float leaves N(0, 1) * 0.02, integer leaves 0):
a production cell's whole state does not fit one card. Skip rules, as the
reference's:

* long_500k only for sub-quadratic archs (SSM/hybrid/SWA);
* SWA archs serve long_500k with a ring-buffer KV cache of window size
  (the ring buffer is the windowed-attention serving design);
* glm4-style tiny-kv caches shard their sequence dim over ``model`` when
  heads do not divide it (sequence-parallel KV).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from ..dist import sharding as shd
from ..models import transformer
from ..models.config import ArchConfig, get_arch
from ..tree import leaves, rebuild
from ..train import optimizer as opt, trainer

SHAPES = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode"},
}

OCFG = opt.OptConfig()


class Cell(NamedTuple):
    """One (arch x shape) cell: ``fn(*args)`` runs it on the mesh."""

    arch: str
    shape: str
    fn: Callable                       # the step to run
    args: Tuple[Any, ...]              # trees of DTensors, placed
    in_shardings: Tuple[Any, ...]      # trees of NamedSharding
    out_shardings: Any
    donate: Tuple[int, ...]            # args the step updates in place
    note: str = ""


def cell_applicable(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """Whether the cell runs for ``cfg``, and why not where it does not."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: 500k decode needs sub-quadratic "
                       "attention (skip per assignment)")
    if shape.startswith(("decode", "long")) and not cfg.supports_decode:
        return False, "no decode step for this arch"
    return True, ""


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, b: int, t: int) -> Dict[str, torch.Tensor]:
    """A step's batch as meta tensors: tokens and labels (B, T) int32, and
    the frontends' rows of the vlm and audio families."""
    out = {"tokens": _meta((b, t), torch.int32),
           "labels": _meta((b, t), torch.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = _meta((b, cfg.n_image_tokens, cfg.d_model),
                                    torch.bfloat16)
    if cfg.family == "audio":
        out["encoder_frames"] = _meta((b, t // cfg.encoder_seq_divisor,
                                       cfg.d_model), torch.bfloat16)
    return out


def _extra_inputs(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in batch.items() if k not in ("tokens", "labels")}


def _batch_shardings(batch: Dict[str, Any], mesh: Any):
    axes = shd.batch_axes(mesh)
    dsize = math.prod(shd.mesh_sizes(mesh)[a] for a in axes)

    def spec(v):
        ax = axes if v.shape[0] % dsize == 0 else ()
        return shd.NamedSharding(mesh, (ax if ax else None,)
                                 + (None,) * (len(v.shape) - 1))
    return {k: spec(v) for k, v in batch.items()}


# a serve-state leaf's batch dim, counted from its end: stacked leaves
# carry their layer axes in front of it
BATCH_FROM_END = {"k": 4, "v": 4, "ssd": 4, "s": 4, "conv": 3, "c": 2,
                  "n": 2, "h": 2, "enc_out": 3}


def _cache_shardings(caches: Any, cfg: ArchConfig, mesh: Any, batch: int):
    """Name-aware serve-state partitioner.

    Batch dim: the dim past the leaf's stacked layer axes (sharded over the
    data axes when divisible). The reference takes the first dim equal to
    the serve batch, which for phi3-mini-3.8b x prefill_32k (32 layers, 32
    rows) is the layer axis: a layer's view of a cache split there has no
    shard on most ranks to be written in place. Model axis preference per
    leaf kind: KV caches try heads, then seq (seq-parallel KV is the
    fallback for tiny-kv archs like glm4), then head_dim; SSM matrix states
    try ssm-heads, then P, then N; conv / sLSTM / encoder states shard
    their channels.
    """
    axes = shd.batch_axes(mesh)
    sizes = shd.mesh_sizes(mesh)
    dsize = math.prod(sizes[a] for a in axes)
    msize = sizes[shd.MODEL]

    def leaf_spec(name, leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return shd.NamedSharding(mesh, ())
        spec: list = [None] * nd
        leaf_name = name.rsplit("/", 1)[-1]
        bdim = nd - BATCH_FROM_END.get(leaf_name, nd)
        if leaf.shape[bdim] == batch and batch % dsize == 0 \
                and "index" not in name:
            spec[bdim] = axes
        if leaf_name in ("k", "v") and nd >= 4:
            prefs = [nd - 2, nd - 3, nd - 1]      # heads, seq, head_dim
        elif leaf_name in ("ssd", "s") and nd >= 4:
            prefs = [nd - 3, nd - 1, nd - 2]      # ssm heads, P, N
        elif leaf_name in ("conv", "c", "n", "h", "enc_out"):
            prefs = [nd - 1]
        else:
            prefs = sorted(range(nd), key=lambda d: -leaf.shape[d])
        for d in prefs:
            if 0 <= d < nd and spec[d] is None and leaf.shape[d] % msize == 0 \
                    and leaf.shape[d] >= msize:
                spec[d] = shd.MODEL
                break
        return shd.NamedSharding(mesh, tuple(spec))

    return rebuild(caches, iter([leaf_spec(n, x) for n, x in leaves(caches)]))


def place(tree: Any, shardings: Any, device: Any = "meta",
          gen: torch.Generator = None) -> Any:
    """``tree``'s leaves (meta tensors of the global shapes) as DTensors
    laid out by ``shardings``: on ``"meta"``, or this rank's shards on
    ``device``, float leaves drawn from ``gen`` (N(0, 1) * 0.02) and
    integer leaves 0."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x, sh):
        d = distribute_tensor(x, sh.mesh, sh.placements, src_data_rank=None)
        if torch.device(device).type == "meta":
            return d
        shape = d.to_local().shape
        if x.dtype.is_floating_point:
            local = torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=device).mul_(0.02).to(x.dtype)
        else:
            local = torch.zeros(shape, dtype=x.dtype, device=device)
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())

    return rebuild(tree, iter([one(x, sh) for (_, x), (_, sh)
                               in zip(leaves(tree), leaves(shardings))]))


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _serve_fn(fn: Callable, mesh: Any) -> Callable:
    """``fn`` run without autograd, on ``mesh``, over DTensor inputs."""
    def run(*args):
        from torch.distributed.tensor.experimental import implicit_replication
        with torch.no_grad(), shd.use_mesh(mesh), implicit_replication():
            return fn(*args)
    return run


def make_cell(arch: str, shape: str, mesh: Any, device: Any = "meta",
              gen: torch.Generator = None) -> Cell:
    """The cell (``arch`` x ``shape``) on ``mesh``, its inputs placed on
    ``device`` (see :func:`place`)."""
    cfg = get_arch(arch)
    info = SHAPES[shape]
    t, b = info["seq_len"], info["global_batch"]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch}×{shape} skipped: {why}")

    if info["kind"] == "train":
        batch = batch_specs(cfg, b, t)
        state = trainer.init_state(cfg, device="meta")
        st_sh = trainer.state_shardings(state, cfg, mesh)
        b_sh = _batch_shardings(batch, mesh)
        fn = trainer.make_train_step(cfg, OCFG, mesh)
        return Cell(arch, shape, fn,
                    (place(state, st_sh, device, gen),
                     place(batch, b_sh, device, gen)),
                    (st_sh, b_sh), (st_sh, None), donate=(0,))

    params = transformer.init_params(cfg, device="meta")
    p_sh = shd.params_shardings(params, cfg, mesh)
    enc_len = t // cfg.encoder_seq_divisor if cfg.family == "audio" else 1
    if info["kind"] == "prefill":
        batch = batch_specs(cfg, b, t)
        extra = _extra_inputs(batch)
        caches = transformer.init_caches(cfg, b, t, enc_len=enc_len,
                                         device="meta")

        def fn(params, tokens, caches, extra):
            return transformer.prefill(params, cfg, tokens, caches,
                                       last_logits_only=True, **extra)
        note = ""
    else:
        ring = cfg.window is not None and shape == "long_500k"
        cache_len = cfg.window if ring else t
        caches = transformer.init_caches(cfg, b, cache_len, enc_len=enc_len,
                                         device="meta")
        batch = batch_specs(cfg, b, 1)
        extra = _extra_inputs(batch)
        # enc-dec decode reads encoder states from caches["enc_out"]
        extra.pop("encoder_frames", None)

        def fn(params, token, caches, extra):
            return transformer.decode_step(params, cfg, token, caches, **extra)
        note = f"ring-buffer KV (window={cfg.window})" if ring else ""

    c_sh = _cache_shardings(caches, cfg, mesh, b)
    tok_sh = _batch_shardings({"tokens": batch["tokens"]}, mesh)["tokens"]
    e_sh = _batch_shardings(extra, mesh)
    args = (place(params, p_sh, device, gen),
            place(batch["tokens"], tok_sh, device, gen),
            place(caches, c_sh, device, gen), place(extra, e_sh, device, gen))
    return Cell(arch, shape, _serve_fn(fn, mesh), args,
                (p_sh, tok_sh, c_sh, e_sh), (None, c_sh, None), donate=(2,),
                note=note)
