"""Train steps: loss, gradients and AdamW, the port of
``repro.train.trainer``.

Two variants, as in the reference:

* :func:`make_train_step`: the production path. Gradients come from
  ``torch.autograd.grad`` over the param leaves; :func:`optimizer.update`
  then writes the new params and moments in place. Given a ``mesh`` (a
  ``DeviceMesh``), the state's leaves are DTensors placed by
  :func:`state_shardings` (:func:`jit_train_step` places them), the batch
  is sharded over the data axes, and each gradient is reduce-scattered
  onto its ZeRO-1 moments' placements before the clip.
* :func:`make_compressed_train_step`: the paper's technique on the
  cross-pod axis. Params carry a leading pod-replica dimension; each pod's
  gradient is BSGS-top-k compressed with error feedback by
  :func:`grad_compress.compressed_grad_mean`, whose ``block_norms``,
  ``block_gather`` and ``block_scatter`` kernels run on the card, and every
  pod applies the same decoded mean. The pods are a loop in one process,
  or, given a ``torch.distributed`` group, one slab of them on each rank,
  which exchange only the compressed payload.

A step takes a state and a batch and returns ``(new state, metrics)``. The
new state holds the same param and moment tensors, updated in place (the
reference's production step donates them), and new 0-d ``step`` and
``opt.count`` tensors; the residuals of the compressed step are new
tensors. Metrics are 0-d tensors on the card: reading one waits for the
step.

Under a mesh the model runs over DTensor leaves inside
``implicit_replication()``: every tensor the model makes for itself
(positions, RoPE tables, masks, fills) is the same on every rank, and
counts as replicated. The compressed step's ``group`` stands for the
reference's ``mesh`` there.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..dist import sharding as shd
from ..models import transformer
from ..models.config import ArchConfig
from ..tree import leaves, params_from_numpy, rebuild, to_numpy, tree_map
from . import grad_compress, optimizer as opt


class TrainState(NamedTuple):
    """Params, AdamW state and the 0-d int32 step count."""

    params: Any
    opt: opt.OptState
    step: torch.Tensor


class CompressedTrainState(NamedTuple):
    """The compressed step's state: every param and moment leaf has a
    leading (n_pods,) replica dimension, and ``residual`` holds each pod's
    f32 error-feedback accumulators."""

    params: Any
    opt: opt.OptState
    residual: Any
    step: torch.Tensor


def init_state(cfg: ArchConfig, gen: Optional[torch.Generator] = None, *,
               device: Any = "cuda") -> TrainState:
    """Random params drawn from ``gen`` on ``device``, zero moments."""
    params = transformer.init_params(cfg, gen, device=device)
    return TrainState(params=params, opt=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _grads(loss_of, params: Any) -> Tuple[Any, Any, Any]:
    """``loss_of(params) -> (scalar, aux)`` and its gradient with respect
    to every leaf of ``params``: (scalar, aux, grads). The leaves are
    differentiated through aliases, so ``params`` never requires grad."""
    flat = [p.detach().requires_grad_() for _, p in leaves(params)]
    with torch.enable_grad():
        with obs.span("train.forward"):
            value, aux = loss_of(rebuild(params, iter(flat)))
        with obs.span("train.backward"):
            grads = torch.autograd.grad(value, flat)
    return value.detach(), aux, rebuild(params, iter(grads))


def state_shardings(state: TrainState, cfg: ArchConfig, mesh: Any,
                    profile: Optional[str] = None) -> TrainState:
    """A :class:`TrainState` of :class:`~repro_torch.dist.sharding.
    NamedSharding`: params by ``profile`` (``cfg.sharding_profile`` when
    None), the moments ZeRO-1, the counts replicated."""
    p_sh = shd.params_shardings(state.params, cfg, mesh, profile)
    o_sh = opt.OptState(
        m=shd.opt_state_shardings(state.opt.m, cfg, mesh, profile),
        v=shd.opt_state_shardings(state.opt.v, cfg, mesh, profile),
        count=shd.NamedSharding(mesh, ()))
    return TrainState(params=p_sh, opt=o_sh, step=shd.NamedSharding(mesh, ()))


def _laid_out_as_moments(grads: Any, moments: Any) -> Any:
    """Each gradient (Partial over the data axes as autograd gives it) in
    its ZeRO-1 moments' placements: one reduce-scatter a leaf, so the
    clip's global norm sums squares over shards and all-reduces a scalar
    (the reference's GSPMD places the gradients by the params'
    ``out_shardings`` in the same way)."""
    return rebuild(grads, iter([
        shd.laid_out_as(g, m) for (_, g), (_, m) in zip(leaves(grads),
                                                        leaves(moments))]))


def _constrain_batch(batch: Dict[str, torch.Tensor], mesh: Any):
    rows = shd.NamedSharding(mesh, (shd.batch_axes(mesh),)).placements
    return {k: shd.as_dtensor(v, mesh).redistribute(mesh, rows)
            for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, ocfg: opt.OptConfig,
                    mesh: Optional[Any] = None):
    """``train_step(state, batch) -> (state', metrics)``; ``batch`` holds
    ``tokens`` and ``labels`` (B, T) on the params' device. Metrics:
    ``loss``, ``aux``, ``total``, ``lr``, ``grad_norm``.

    With a ``mesh``, ``state`` holds DTensors (:func:`jit_train_step`), the
    batch is sharded over the data axes (a plain tensor is taken as the
    whole batch, the same on every rank), the model runs under
    ``implicit_replication()`` with ``mesh`` ambient for its ``constrain``
    and ``shard_map_batch`` calls, and the metrics come back as plain
    tensors, the same on every rank."""
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with obs.step():
            total, metrics, grads = _grads(
                lambda p: transformer.loss_fn(p, cfg, batch), state.params)
            if mesh is not None:
                grads = _laid_out_as_moments(grads, state.opt.m)
            params, new_opt, om = opt.update(ocfg, grads, state.opt,
                                             state.params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return TrainState(params=params, opt=new_opt, step=state.step + 1), \
            dict(metrics, **om, total=total)

    if mesh is None:
        return train_step

    def mesh_step(state: TrainState, batch: Dict[str, torch.Tensor]
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication
        with shd.use_mesh(mesh), implicit_replication():
            state, metrics = train_step(state, _constrain_batch(batch, mesh))
            metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
        return state, metrics

    return mesh_step


def jit_train_step(cfg: ArchConfig, ocfg: opt.OptConfig, mesh: Any,
                   state: TrainState, profile: Optional[str] = None):
    """``(step, placed state)``: ``state`` laid out by
    :func:`state_shardings` on ``mesh`` and the mesh step of
    :func:`make_train_step` for it. Every rank passes the same whole
    state; each keeps its shards of it, with no collective.

    The name is the reference's, which jits the step with these shardings
    and donates the state. Nothing is compiled here: the step runs eagerly
    over DTensors, and its in-place update of the params and moments
    stands for the donation."""
    from torch.distributed.tensor import distribute_tensor
    shardings = state_shardings(state, cfg, mesh, profile)
    placed = rebuild(state, iter([
        distribute_tensor(x, sh.mesh, sh.placements, src_data_rank=None)
        for (_, x), (_, sh) in zip(leaves(state), leaves(shardings))]))
    return make_train_step(cfg, ocfg, mesh), placed


def init_compressed_state(cfg: ArchConfig, gen: Optional[torch.Generator],
                          n_pods: int, *,
                          device: Any = "cuda") -> CompressedTrainState:
    """One draw of params copied to ``n_pods`` replicas, zero moments and
    residuals."""
    params = transformer.init_params(cfg, gen, device=device)
    podded = tree_map(
        lambda x: x[None].expand((n_pods,) + x.shape).contiguous(), params)
    del params
    return CompressedTrainState(
        params=podded, opt=opt.init(podded),
        residual=tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                device=x.device), podded),
        step=torch.zeros((), dtype=torch.int32, device=device))


def make_compressed_train_step(cfg: ArchConfig, ocfg: opt.OptConfig,
                               ratio: float = 0.05, group: Any = None):
    """``train_step(state, batch) -> (state', metrics)``; ``batch`` leaves
    are (n_pods, local_batch, T). The loss is the mean of the pods' totals,
    so each pod's gradient carries 1/n_pods, as the reference's
    ``value_and_grad`` of the mean gives it. Metrics: ``loss``, ``lr``,
    ``grad_norm``, ``wire_ratio``.

    With a ``torch.distributed`` ``group``, the state and batch are this
    rank's slab of the pod dimension (ranks in pod order): the compressed
    payload is gathered over the group (:func:`grad_compress.
    compressed_grad_mean`), the pods' losses too, and the clip uses the
    norm of the whole podded gradient, so each rank's slab ends the step
    as the single-process run's pods would."""
    world = 1
    if group is not None:
        import torch.distributed as dist
        world = dist.get_world_size(group)

    def _scaled_total(params, batch, n_pods):
        total = transformer.loss_fn(params, cfg, batch)[0]
        return total / n_pods, total

    def train_step(state: CompressedTrainState, batch: Dict[str, torch.Tensor]):
        with obs.step():
            flat = leaves(state.params)
            n_local = flat[0][1].shape[0]
            n_pods = n_local * world
            grads = tree_map(torch.empty_like, state.params)
            g_flat = [g for _, g in leaves(grads)]
            losses = []
            for i in range(n_local):
                # pods share no param, so each pod's backward is its own
                pod_params = rebuild(state.params, iter([p[i] for _, p in flat]))
                pod_batch = {k: v[i] for k, v in batch.items()}
                _, total, g_i = _grads(lambda p: _scaled_total(p, pod_batch, n_pods),
                                       pod_params)
                for dst, (_, src) in zip(g_flat, leaves(g_i)):
                    dst[i].copy_(src)
                losses.append(total.detach())
                del g_i
            losses = torch.stack(losses)
            if group is not None:
                losses = grad_compress.gather_pods(losses, group)
            loss = losses.mean()
            mean_g, new_res, stats = grad_compress.compressed_grad_mean(
                grads, state.residual, ratio=ratio, group=group)
            del grads
            # the clip's norm is over every pod's copy of the mean, as the
            # reference's podded gradient has them, on a rank of a group too
            norm = opt.global_norm(tree_map(
                lambda g: g[None].expand((n_pods,) + g.shape), mean_g))
            podded_g = tree_map(lambda g: g[None].expand((n_local,) + g.shape),
                                mean_g)
            params, new_opt, om = opt.update(ocfg, podded_g, state.opt,
                                             state.params, grad_norm=norm)
            metrics = dict(om, loss=loss, wire_ratio=(
                grad_compress.compression_ratio_bytes(stats)))
            return CompressedTrainState(params=params, opt=new_opt,
                                        residual=new_res,
                                        step=state.step + 1), metrics

    return train_step


# -- carrying state across packages --------------------------------------------


def state_from_numpy(ref: Any, device: Any = "cuda") -> Any:
    """The reference's ``TrainState`` or ``CompressedTrainState`` with numpy
    leaves (``jax.tree.map(np.asarray, state)``) as the port's state of the
    same kind on ``device``, byte for byte."""
    def conv(tree):
        return params_from_numpy(tree, device)
    o = opt.OptState(m=conv(ref.opt.m), v=conv(ref.opt.v),
                     count=conv(np.asarray(ref.opt.count)))
    step = conv(np.asarray(ref.step))
    if hasattr(ref, "residual"):
        return CompressedTrainState(params=conv(ref.params), opt=o,
                                    residual=conv(ref.residual), step=step)
    return TrainState(params=conv(ref.params), opt=o, step=step)


def state_to_numpy(state: Any) -> Any:
    """The inverse of :func:`state_from_numpy`: the port's state with host
    numpy leaves of the same bytes (the port's NamedTuple types; the
    reference's step reads them by field name)."""
    return tree_map(to_numpy, state)
