"""Sharding rule engine: DTensor placements for params, opt state, batch.
The port of ``repro.dist.sharding``, whose GSPMD partition specs it keeps
rule for rule.

One place decides how every tensor lays out over the mesh:

* ``batch_axes(mesh)``: the data-parallel axes (``("pod", "data")`` on the
  multi-pod mesh, ``("data",)`` otherwise); batches shard their leading
  dim over them.
* ``params_shardings`` / ``opt_state_shardings``: per-leaf
  :class:`NamedSharding`. Profile ``tp`` shards each weight's largest
  divisible dim over ``model``; ``fsdp_tp`` also shards a second dim over
  the data axes (ZeRO-3 style). Optimizer moments always take the data
  axes too (ZeRO-1): they are touched once per step, so their gathers are
  off the critical path.
* ``constrain(x, axes)``: a layout for model code. ``axes`` entries are
  ``"batch"`` (the data axes), ``"model"``, a literal mesh axis name, or
  ``None``. First-divisible-wins: when several dims name the same mesh
  axis, the first whose extent divides the axis size takes it and the rest
  stay replicated (a mesh axis can partition only one dim). Outside
  :func:`use_mesh` it is the identity.
* ``stream(x)``, ``in_stream``, ``rejoin``: the residual stream's layout
  of a step that writes no cache, chosen once (batch over the data axes,
  the sequence over ``model``, whole on d); ``entering(x)`` and
  ``use_weight(w, dim)`` lay a sub-layer's input and weights out over it:
  column-parallel in, row-parallel out (Megatron-LM's), each weight moved
  to where the layer uses it; ``entering(x, rows=True)`` lays it out for a
  recurrent sub-layer that runs whole on each rank's rows (the batch over
  the data axes and ``model`` together, as far as the rows divide; where
  ``model`` holds a data rank's rows whole, ``shard_call(..., rows=True)``
  runs each rank on its part of them);
  ``per_op(x)`` hands MoE sub-layers the stream split on d, where their
  ops lay themselves out.

Three helpers run a function on plain local shards, one case each:

* ``shard_map_batch(fn, *args)``: ``fn`` batch-locally on each rank's
  rows (the MoE dispatch's batched gathers and tables, a recurrent scan).
  Outside :func:`use_mesh` it is ``fn(*args)``.
* ``local_call(fn, placements, *args)``: every arg redistributed to one
  shared layout first (attention's batch and heads in a prefill, a
  cumsum over T).
* ``shard_call(fn, out_placements, *args)``: each arg's shard as it lies,
  with the rank's offset along every split dim, the outputs in the
  placements the caller names: the layers over the stream (their
  gradients Partial where the outputs split the work; a recurrent
  sub-layer on its rank's rows, or on its part of them and its share of
  their heads, weights whole), the
  KV cache's writes and the flash-decode combine over a cache split on
  seq.

A :class:`NamedSharding` keeps the reference's per-dim spec (a tuple of
``None``, an axis name or a tuple of axis names, as ``PartitionSpec``
holds it) beside the torch placements it means: one ``Shard(d)`` or
``Replicate()`` per mesh dim. A tuple entry puts several mesh dims on one
tensor dim, major first, as DTensor orders repeated ``Shard(d)``. The rules
read only a mesh's dim names and sizes, so they run on a torch
``DeviceMesh`` or on an :class:`AbstractMesh` of any size without a
process group, as the reference's run on ``jax.sharding.AbstractMesh``.

Where the reference hints with ``with_sharding_constraint`` and lets GSPMD
choose the collectives, ``constrain`` redistributes: the layout it asks for
is the one the next op sees. A tensor that is not a DTensor (one the model
makes for itself) counts as replicated.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from ..tree import leaves, rebuild

MODEL = "model"
DATA = "data"
POD = "pod"

Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's dim sizes and names, with no devices: what the rules need,
    the counterpart of ``jax.sharding.AbstractMesh``."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def mesh_sizes(mesh: Any) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


@dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout over ``mesh``: ``spec`` has one entry per tensor
    dim (``None``, an axis name, or a tuple of axis names)."""

    mesh: Any
    spec: Spec

    def __post_init__(self):
        # as PartitionSpec holds them: a one-name tuple is the name, and an
        # empty one is None
        object.__setattr__(self, "spec", tuple(
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple) else e
            for e in self.spec))

    @property
    def placements(self) -> tuple:
        """One ``Shard(d)`` / ``Replicate()`` per mesh dim, in its order."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names:
            dim = next((d for d, entry in enumerate(self.spec)
                        if entry == name or (isinstance(entry, tuple)
                                             and name in entry)), None)
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)


# ---------------------------------------------------------------------------
# the ambient mesh
# ---------------------------------------------------------------------------

# process-wide, not per thread or context: autograd runs the backward pass
# of CUDA tensors on threads of its own, and a remat recompute there must
# lay its tensors out as the forward pass did
_MESHES: List[Any] = []


def current_mesh() -> Optional[Any]:
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _MESHES[-1] if _MESHES else None


@contextlib.contextmanager
def use_mesh(mesh: Any) -> Iterator[Any]:
    """Make ``mesh`` the ambient mesh of ``constrain`` and
    ``shard_map_batch`` (the reference's ``with mesh:``)."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def batch_axes(mesh: Any) -> tuple:
    """Mesh axes the batch dim shards over (pod-major on multi-pod meshes).

    Always a tuple: callers iterate it and splice it into specs (a tuple of
    names is a valid single-dim spec entry).
    """
    return tuple(a for a in (POD, DATA) if a in mesh.mesh_dim_names)


def _axes_size(mesh: Any, axes: Union[str, tuple, None]) -> int:
    if axes is None or axes == ():
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


# ---------------------------------------------------------------------------
# layouts for model code
# ---------------------------------------------------------------------------


def _resolve_spec(shape: Sequence[int], axes: Sequence[Any], mesh: Any) -> Spec:
    spec: List[Any] = [None] * len(shape)
    used: set = set()
    for d, want in enumerate(axes[: len(shape)]):
        if want is None:
            continue
        resolved = batch_axes(mesh) if want == "batch" else want
        if resolved is None or resolved == ():
            continue
        names = (resolved,) if isinstance(resolved, str) else tuple(resolved)
        if any(n not in mesh.mesh_dim_names or n in used for n in names):
            continue
        size = _axes_size(mesh, names)
        # first-divisible-wins: an indivisible dim stays replicated (e.g.
        # kv heads % model on GQA archs)
        if size <= 1 or shape[d] % size != 0:
            continue
        spec[d] = resolved
        used.update(names)
    return tuple(spec)


def as_dtensor(x: torch.Tensor, mesh: Any):
    """``x`` as a DTensor on ``mesh``: itself if it is one, else replicated
    (the same tensor on every rank)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def meet(x: torch.Tensor, like: Any, dims: dict) -> torch.Tensor:
    """``x`` laid out to meet DTensor ``like`` where it lies: a mesh dim
    that splits dim ``j`` of ``like`` splits dim ``dims[j]`` of ``x`` (the
    dims they share), and ``x`` is whole on every other mesh dim. An op of
    the two then needs no byte of ``like`` from another rank (an expert's
    weights, a recurrent state). ``x`` itself when ``like`` is not a
    DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(like, DTensor):
        return x
    mesh = like.device_mesh
    placements = tuple(Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                       else Replicate() for p in like.placements)
    return as_dtensor(x, mesh).redistribute(mesh, placements)


def laid_out_as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` in ``like``'s placements where both are DTensors that differ
    (a gradient and its ZeRO-1 moment, a step and its param), else ``x``
    itself."""
    placements = getattr(like, "placements", None)
    if placements is None or x.placements == placements:
        return x
    return x.redistribute(like.device_mesh, placements)


def whole_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dim ``dim`` whole on every rank, its other placements
    kept (a stacked layer axis before it is unbound); ``x`` itself when it
    is not a DTensor or the dim is not split."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    placements = tuple(Replicate() if getattr(p, "dim", None) == dim else p
                       for p in x.placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain(x: torch.Tensor, axes: Sequence[Any]) -> torch.Tensor:
    """``x`` laid out as ``axes`` asks on the ambient mesh (identity
    outside one)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = _resolve_spec(x.shape, list(axes), mesh)
    out = as_dtensor(x, mesh).redistribute(
        mesh, NamedSharding(mesh, spec).placements)
    # a shard of a dim past the first is a strided view of the whole, and
    # DTensor's local views (einsum's reshapes) need it dense
    return out if out.to_local().is_contiguous() else out.contiguous()


def local_call(fn, placements: Sequence[Any], *args):
    """Run ``fn`` on each rank's shards of ``args``, every one laid out as
    ``placements`` on the ambient mesh; the outputs (tensors, or a tree of
    them) come back as DTensors in the same layout. ``fn`` sees plain
    tensors, so it may use any op, and must compute each output shard from
    the matching input shards alone."""
    from torch.distributed.tensor import DTensor
    mesh = current_mesh()
    local = [as_dtensor(a, mesh).redistribute(mesh, placements).to_local()
             for a in args]
    out = fn(*local)
    return rebuild(out, iter([
        DTensor.from_local(o, mesh, placements, run_check=False)
        for _, o in leaves(out)]))


def shard_spans(x: torch.Tensor) -> dict:
    """``{tensor dim: (offset, extent)}`` of this rank's shard of DTensor
    ``x`` along each split dim (several mesh dims on one tensor dim split
    it major first); ``{}`` for a plain tensor. Splits must be even."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return {}
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    parts: dict = {}
    for mdim, p in enumerate(x.placements):
        if p.is_shard():
            n, i = parts.get(p.dim, (1, 0))
            parts[p.dim] = (n * mesh.size(mdim), i * mesh.size(mdim)
                            + coord[mdim])
    spans = {}
    for dim, (n, i) in parts.items():
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"evenly {n} ways")
        extent = x.shape[dim] // n
        spans[dim] = (i * extent, extent)
    return spans


def shard_call(fn, out_placements: Optional[Sequence[Any]], *args,
               rows: bool = False):
    """Run ``fn(spans, *shards)`` on each DTensor argument's local shard as
    it lies, with no redistribution (lay the arguments out first:
    :func:`entering`, :func:`use_weight`; a KV cache stays where it is):
    ``spans[i]`` is :func:`shard_spans` of argument ``i``. The outputs (a
    tensor, a tree of them, or None for a call that writes its arguments in
    place) come back as DTensors in ``out_placements`` on the arguments'
    mesh. A mesh dim where an output is not Replicate splits the work: an
    argument whole on it gets its gradient Partial there (each rank's part
    of the sum; a weight's gradient over the stream is Partial over the
    data axes), a split one keeps its split. ``fn`` sees plain tensors and
    no ambient mesh (the plain code) and must compute each output shard
    from its rank's shards alone; where it needs other ranks' shards it
    runs the collectives itself. Plain tensors among ``args`` pass as they
    are.

    With ``rows`` the first argument is a batch laid out by
    :func:`entering` with ``rows``, ``fn(group, rows, *shards)`` returns
    one tensor of its rows and ``group`` is None, except where ``model``
    holds a data rank's rows whole (:func:`row_share`). There the rows cut
    into ``parts`` and each part's ``share`` consecutive ``model`` ranks
    form its :class:`RowShare` ``group``: each rank runs ``fn`` on its
    part's rows and the group's heads it takes (:meth:`RowShare.heads`),
    its output is its share of the part's sum, and one all-gather over
    ``model`` sums each group's outputs into every part, whole on every
    rank (:class:`_GatherParts`). ``model`` then splits the work: the
    arguments' gradients are Partial over it."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    splits = [out_placements is not None and not p.is_replicate()
              for p in (out_placements or (None,) * mesh.ndim)]
    parts, share = row_share(mesh, args[0].shape[0]) if rows else (1, 1)
    if share > 1:
        dim = mesh.mesh_dim_names.index(MODEL)
        part, index = divmod(mesh.get_coordinate()[dim], share)
        splits[dim] = True
    spans = [shard_spans(a) for a in args]
    local = [a.to_local(grad_placements=tuple(
                 Partial() if s and p.is_replicate() else p
                 for s, p in zip(splits, a.placements)))
             if isinstance(a, DTensor) else a for a in args]
    with use_mesh(None):
        if share > 1:
            n = local[0].shape[0] // parts
            group = RowShare(mesh, dim, share, index)
            y = fn(group, local[0][part * n:(part + 1) * n], *local[1:])
            out = _GatherParts.apply(y, mesh, dim, part, share,
                                     share // group.ways)
        else:
            out = fn(None if rows else spans, *local)
    if out is None:
        return None
    return rebuild(out, iter([
        DTensor.from_local(o, mesh, tuple(out_placements), run_check=False)
        for _, o in leaves(out)]))


def shard_map_batch(fn, *args, whole: Sequence[Any] = ()):
    """Run ``fn`` with each arg's leading (batch) dim split over the data
    axes; outputs are reassembled on the same layout. Batch-local compute
    only: ``fn`` must not reduce across the batch dim. Each rank calls
    ``fn`` on plain tensors, its rows of every arg (all of them where the
    rows do not split over the data axes), then the tensors of ``whole``
    whole (a weight the rows share: its gradient sums over the ranks'
    rows)."""
    mesh = current_mesh()
    if mesh is None:
        return fn(*args, *whole)
    axes = batch_axes(mesh)
    dsize = _axes_size(mesh, axes)
    from torch.distributed.tensor import Partial, Replicate
    split = all(a.shape[0] % dsize == 0 for a in args)
    # rows that do not split (a decode batch of one) are replicated, as
    # the batch rules lay them out, and each rank runs all of them
    rows = NamedSharding(mesh, (axes,) if split else ()).placements
    grads = tuple(Partial() if split and name in axes else Replicate()
                  for name in mesh.mesh_dim_names)
    shared = [as_dtensor(w, mesh).redistribute(
        mesh, (Replicate(),) * mesh.ndim).to_local(grad_placements=grads)
        for w in whole]
    return local_call(lambda *a: fn(*a, *shared), rows, *args)


# ---------------------------------------------------------------------------
# the residual stream's layout, chosen once (Megatron-LM's)
# ---------------------------------------------------------------------------

STREAM_AXES = ("batch", MODEL)


def stream(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, T, ...) in the residual stream's layout: the batch over the
    data axes, the sequence over ``model`` where it divides the axis
    (Megatron-LM's sequence parallelism: a rank keeps 1/model of what
    remat saves a layer), whole on d. A train step's stream takes it once,
    at the embedding, and keeps it across every super-block
    (:func:`rejoin`); identity outside a mesh."""
    return constrain(x, STREAM_AXES)


def in_stream(x: Any) -> bool:
    """Whether DTensor ``x`` lies in the stream's layout on the ambient
    mesh. The layers over such an ``x`` run on local shards
    (:func:`shard_call`) of it whole on T (:func:`entering`): the
    projections that widen it split their output over ``model``
    (:func:`use_weight`), the ones that narrow it contract over that split
    and leave a Partial, reduce-scattered back onto the sequence once per
    sub-layer (:func:`rejoin`). False outside a mesh and for a stream
    laid out otherwise: a cache's prefill and decode steps keep their rows
    split on d, where the weights stay as they lie."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return False
    spec = _resolve_spec(x.shape, STREAM_AXES, mesh)
    return tuple(x.placements) == NamedSharding(mesh, spec).placements


class _ReducedGrad(torch.autograd.Function):
    """Identity forward; in the backward pass the gradient is laid out as
    the input was (Megatron-LM's ``f``: each rank's part of a gradient
    summed at once)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


def _row_axes(mesh: Any, rows: int) -> tuple:
    """The longest major-first run of the data axes and ``model`` whose
    size divides ``rows``: what a recurrent sub-layer's batch splits over
    (the rest of the mesh holds it whole: see :func:`row_share`)."""
    axes = batch_axes(mesh) + ((MODEL,) if MODEL in mesh.mesh_dim_names
                               else ())
    while axes and rows % _axes_size(mesh, axes):
        axes = axes[:-1]
    return axes


def row_share(mesh: Any, rows: int) -> Tuple[int, int]:
    """``(parts, share)`` of a recurrent sub-layer's ``rows`` (its batch,
    laid out by :func:`entering` with ``rows``) on ``mesh``: where the data
    axes split the rows and ``model`` does not, ``model`` holds each data
    rank's rows whole. They then cut into ``parts``, the largest divisor
    of ``model``'s size that divides a data rank's rows, and each part is
    shared by ``share = model // parts`` consecutive ``model`` ranks, which
    split its heads (:class:`RowShare`). A multi-pod (2, 16, 16) mesh's
    train_4k batch: 8 rows a data rank, 8 parts of one row, each shared by
    2 of the 16 ``model`` ranks; one row a data rank: 1 part shared by all
    of ``model``. ``(1, 1)`` elsewhere: each rank runs its own rows."""
    data = batch_axes(mesh)
    if MODEL not in mesh.mesh_dim_names or _row_axes(mesh, rows) != data:
        return 1, 1
    rows, m = rows // _axes_size(mesh, data), mesh_sizes(mesh)[MODEL]
    parts = max(k for k in range(1, m + 1) if m % k == 0 and rows % k == 0)
    return parts, m // parts


def head_ways(heads: int, share: int) -> int:
    """Over how many of a share group's ``share`` ranks a sub-layer of
    ``heads`` heads splits them: the largest divisor of ``share`` that
    divides ``heads`` (:meth:`RowShare.heads`)."""
    return max(k for k in range(1, share + 1)
               if share % k == 0 and heads % k == 0)


class RowShare:
    """The ``share`` consecutive ``model`` ranks (mesh dim ``dim``) that
    hold one part of a recurrent sub-layer's rows, seen from the rank at
    ``index`` among them (:func:`shard_call` with ``rows``), and their
    process group. The sub-layer splits its heads over ``ways`` of them
    (:meth:`heads`); where ``ways`` is less than ``share``, each ``share //
    ways`` ranks in a row take the same heads and compute the same values
    (the duplicates, which :class:`_GatherParts` and :meth:`gather`
    average)."""

    def __init__(self, mesh: Any, dim: int, share: int, index: int):
        self.share, self.index = share, index
        self.pg = _share_group(mesh, dim, share)
        self.ways = 1

    def heads(self, heads: int) -> Tuple[int, int]:
        """``(ways, k)``: the group splits ``heads`` heads ``ways`` ways
        (:func:`head_ways`) and this rank takes the ``k``-th ``heads //
        ways`` of them."""
        self.ways = head_ways(heads, self.share)
        return self.ways, self.index // (self.share // self.ways)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(ways, *x.shape): each of the ``ways`` head slices' ``x``, in
        order, on every rank of the group (one all-gather in the group; its
        backward a reduce-scatter there)."""
        return _GatherShare.apply(x, self)


# {(id of a model group, share): (that group, this rank's share group)};
# the model group is held so that its id is not reused by a later one
_SHARE_GROUPS: dict = {}


def _share_group(mesh: Any, dim: int, share: int):
    """This rank's process group of ``share`` consecutive ranks along mesh
    dim ``dim``. Made once per ``model`` group and ``share``: every rank
    makes every such group, in one order, where :func:`shard_call` first
    needs one (all ranks reach it together)."""
    import torch.distributed as dist
    pg = mesh.get_group(dim)
    key = (id(pg), share)
    if key not in _SHARE_GROUPS:
        ranks = mesh.mesh.movedim(dim, -1).reshape(-1, share).tolist()
        mine, _ = dist.new_subgroups_by_enumeration(ranks)
        _SHARE_GROUPS[key] = (pg, mine)
    return _SHARE_GROUPS[key][1]


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(ranks of ``group``, *x.shape): ``x`` of each, in rank order."""
    import torch.distributed as dist
    ranks = dist.get_world_size(group)
    out = x.new_empty((ranks * x.shape[0],) + x.shape[1:])
    # all_gather_into_tensor's newer name, where torch has it
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, x.contiguous(), group=group)
    return out.unflatten(0, (ranks, -1))


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (ranks of ``group``, n, ...) summed over the group's ranks,
    each rank keeping its own row."""
    import torch.distributed as dist
    out = x.new_empty(x.shape[1:])
    scatter = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
    scatter(out, x.flatten(0, 1).contiguous(), group=group)
    return out


class _GatherShare(torch.autograd.Function):
    """:meth:`RowShare.gather`: one all-gather in the share group, each head
    slice the mean of the ranks that took it. Backward: one reduce-scatter
    there, each rank's slice of the group's gradients summed, over its
    duplicates."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        dup = group.share // group.ways
        got = _all_gather(x, group.pg)
        return got if dup == 1 else \
            got.unflatten(0, (group.ways, dup)).sum(1) / dup

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        dup = group.share // group.ways
        if dup == 1:
            return _reduce_scatter(grad, group.pg), None
        mine = _reduce_scatter(grad.repeat_interleave(dup, 0), group.pg)
        return mine / dup, None


class _GatherParts(torch.autograd.Function):
    """This rank's output ``y`` for part ``part`` of the rows (the
    ``share`` ranks in a row along mesh dim ``dim`` that hold the part
    each give their share of its sum) -> every part, whole, in order: one
    all-gather over the dim, each group's outputs summed, over ``dup``
    where ``dup`` ranks compute each share alike. Backward: the rank's
    part of the gradient (over ``dup``), since the arguments' gradients
    sum over the dim (Partial there)."""

    @staticmethod
    def forward(ctx, y, mesh, dim, part, share, dup):
        ctx.n, ctx.part, ctx.dup = y.shape[0], part, dup
        out = _all_gather(y, mesh.get_group(dim)).unflatten(
            0, (-1, share)).sum(1)
        return (out if dup == 1 else out / dup).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        g = g[ctx.part * n:(ctx.part + 1) * n]
        return (g if ctx.dup == 1 else g / ctx.dup), None, None, None, None, \
            None


def entering(x: torch.Tensor, rows: bool = False) -> torch.Tensor:
    """DTensor ``x`` (the stream, or a cross-attention's states) entering a
    sub-layer that runs on local shards: its batch over the data axes,
    whole on every other dim (a sequence split over ``model`` is gathered).
    With ``rows`` its batch splits over the data axes and ``model``
    together, major first, as far as the rows divide (:func:`_row_axes`),
    for a sub-layer that runs whole on each rank's rows (a recurrent scan
    over T: the sequence moves to the rows by one all-to-all over
    ``model``, and back in the backward pass). Its gradient, Partial over
    the mesh dims that split the sub-layer, is reduced right here to
    ``x``'s own layout (reduce-scattered onto a split sequence), so the
    backward pass of the norm before it runs on the whole gradient, as the
    plain code's does, whatever DTensor's rules would choose. ``x`` itself
    when it is not a DTensor."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    axes = (_row_axes(mesh, x.shape[0]),) if rows else ("batch",)
    whole = NamedSharding(mesh, _resolve_spec(x.shape, axes,
                                              mesh)).placements
    if tuple(x.placements) != whole:
        return x.redistribute(mesh, whole)
    return _ReducedGrad.apply(x)


def per_op(x: torch.Tensor) -> torch.Tensor:
    """The stream ``x`` laid out for a sub-layer whose ops lay themselves
    out (MoE's tables and experts): the batch over the data axes, d over
    ``model``, as the embedding gives a stream that
    does not take the stream's layout, so those ops, their residual add
    (:func:`rejoin`) and their gradients lay themselves out as they do
    there; ``x`` itself when it is not in the stream's layout."""
    return constrain(x, ("batch", None, MODEL)) if in_stream(x) else x


def rejoin(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``y`` laid out as the stream ``x`` where ``x`` is in the stream's
    layout (a sub-layer's Partial output is reduce-scattered onto the
    sequence; a per-op sub-layer's residual sum over :func:`per_op` of
    ``x`` goes back from d to the sequence); ``y`` itself otherwise."""
    return laid_out_as(y, x) if in_stream(x) else y


def model_coordinate() -> Tuple[int, int]:
    """(this rank's index along ``model``, the axis' size) on the ambient
    mesh; (0, 1) outside one or without the axis."""
    mesh = current_mesh()
    if mesh is None or MODEL not in mesh.mesh_dim_names:
        return 0, 1
    d = mesh.mesh_dim_names.index(MODEL)
    return mesh.get_coordinate()[d], mesh.size(d)


class _UseWeight(torch.autograd.Function):
    """A weight redistributed to where a layer uses it. Its gradient goes
    back to the weight's own placements on the mesh dims that split the
    weight (a reduce-scatter where it was gathered) and stays Partial on
    the others (the data axes), where DTensor's own backward would
    all-reduce it."""

    @staticmethod
    def forward(ctx, w, placements):
        ctx.src = tuple(w.placements)
        return w.redistribute(w.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial
        target = tuple(Partial() if p.is_replicate() and q.is_partial() else p
                       for p, q in zip(ctx.src, g.placements))
        return g.redistribute(g.device_mesh, target), None


def use_weight(w: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """Weight ``w`` laid out for a layer over the stream: split over
    ``model`` on ``dim`` (its output dim for a projection that widens the
    stream, its input dim for one that narrows it), whole where ``dim`` is
    None or its extent does not divide the axis, and whole over the data
    axes (the ZeRO-3 gather of ``fsdp_tp``). Where ``w``'s own split falls
    elsewhere (granite-3-8b's ``wq``, split on d_in by the largest-extent
    rule) the weight moves, not the activation: a layer's weight is 8-32 MB
    in bf16, the (16, 4096, 4096) activation of a train_4k rank 537 MB.
    ``w`` itself outside a mesh or where it already lies so."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard
    m = mesh_sizes(mesh).get(MODEL, 1)
    split = dim is not None and m > 1 and w.shape[dim] % m == 0
    target = tuple(Shard(dim) if name == MODEL and split else Replicate()
                   for name in mesh.mesh_dim_names)
    if target == tuple(w.placements):
        return w
    return _UseWeight.apply(w, target)


def split_like(x: torch.Tensor, model: Any) -> tuple:
    """``x``'s placements with the ``model`` mesh dim's replaced by
    ``model`` (a layer's output: ``Partial()`` after a contraction over
    the split, ``Shard(d)`` for rows split over ``model``)."""
    mesh = current_mesh()
    return tuple(model if name == MODEL else p
                 for name, p in zip(mesh.mesh_dim_names, x.placements))


# ---------------------------------------------------------------------------
# state shardings
# ---------------------------------------------------------------------------


def _leaf_sharding(shape: Sequence[int], mesh: Any, *,
                   fsdp: bool) -> NamedSharding:
    nd = len(shape)
    spec: List[Any] = [None] * nd
    msize = mesh_sizes(mesh).get(MODEL, 1)
    # tensor-parallel dim: largest extent divisible by the model axis
    if msize > 1 and nd >= 1:
        for d in sorted(range(nd), key=lambda d: -shape[d]):
            if shape[d] >= msize and shape[d] % msize == 0:
                spec[d] = MODEL
                break
    if fsdp:
        daxes = batch_axes(mesh)
        dsize = _axes_size(mesh, daxes)
        if dsize > 1:
            for d in sorted(range(nd), key=lambda d: -shape[d]):
                if spec[d] is None and shape[d] >= dsize and shape[d] % dsize == 0:
                    spec[d] = daxes
                    break
    return NamedSharding(mesh, tuple(spec))


def _map_leaves(fn, tree: Any) -> Any:
    return rebuild(tree, iter([fn(tuple(x.shape)) for _, x in leaves(tree)]))


def params_shardings(params: Any, cfg: Any, mesh: Any,
                     profile: Optional[str] = None) -> Any:
    """Tree of :class:`NamedSharding` matching ``params``.

    ``profile`` overrides ``cfg.sharding_profile`` (``tp`` | ``fsdp_tp``).
    """
    profile = profile or getattr(cfg, "sharding_profile", "tp")
    fsdp = profile == "fsdp_tp"
    return _map_leaves(lambda s: _leaf_sharding(s, mesh, fsdp=fsdp), params)


def opt_state_shardings(tree: Any, cfg: Any, mesh: Any,
                        profile: Optional[str] = None) -> Any:
    """Adam moments: ZeRO-1, always the data axes on top of TP.

    Moments are read and written once per step (not per layer per
    microbatch), so sharding them over data costs one reduce-scatter /
    all-gather pair off the forward/backward critical path and divides
    optimizer-state memory by the data-parallel degree.
    """
    return _map_leaves(lambda s: _leaf_sharding(s, mesh, fsdp=True), tree)
