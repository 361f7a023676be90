"""What one rank's program costs, counted op by op as it runs: the port's
counterpart of ``repro.analysis.hlo_cost``, which walks the compiled SPMD
program of one device.

:func:`analyze` runs ``fn`` under a dispatch mode that sees every aten op
this process executes on plain tensors, forward and backward:

* FLOPs of the matmul-like ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions, attention kernels) at the shapes they run at, from
  ``torch.utils.flop_counter``'s formulas (2 · M · N · K for a matmul);
  elementwise ops count no FLOPs, as the reference counts only dots; and
  the same FLOPs again by ``"<op> @ <site>"`` (the site as below), so a
  rank's excess over its share names the op that does it;
* bytes: the operands plus the results of every op that is not a view or
  an allocation: an upper bound, since nothing is fused;
* collective bytes (the output of each collective) and counts, by kind:
  ``all_gather``, ``all_reduce``, ``reduce_scatter``, ``all_to_all`` (DTensor's
  ``shard_dim_alltoall`` too, which moves a shard between dims); and
  by kind, the same again by what caused each one, ``"<op> @ <site>"``:
  the aten op whose DTensor dispatch redistributed its inputs (or
  ``redistribute`` for an explicit one, ``collective`` for one the code
  calls itself) and the innermost function of this package on the stack
  (inside autograd's engine ``backward`` and the node it runs, as
  ``backward MmBackward0``). This is the counterpart of
  reading a collective's operand in the reference's HLO text.

Where the arguments are DTensors, the mode lets DTensor run the op; DTensor
then runs its local ops and collectives on each rank's shards, and the
mode counts those at their local shapes. So a rank of a mesh counts its own
program, as the reference counts the per-device program. The ops DTensor
runs on fake tensors to infer global shapes are not counted.

The reference multiplies each loop body by its trip count, since XLA
counts a ``while`` body once. Python loops here run op by op, so every
iteration is counted as it runs and no correction is needed.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

KINDS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "_local_scalar_dense",
         "wait_tensor", "_wrap_tensor_autograd", "set_"}


@dataclass
class Cost:
    """FLOPs, bytes, and collective bytes and counts by kind."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_count: Dict[str, float] = field(default_factory=dict)
    # kind -> "<op> @ <site>" -> [bytes, count]
    coll_by_op: Dict[str, Dict[str, List[float]]] = field(default_factory=dict)
    # "<op> @ <site>" -> [FLOPs, count]
    flops_by_op: Dict[str, List[float]] = field(default_factory=dict)
    largest: Tuple[float, str, str] = (0.0, "", "")   # bytes, kind, op

    @property
    def total_coll_bytes(self) -> float:
        """Collective bytes over every kind."""
        return float(sum(self.coll_bytes.values()))

    def as_dict(self) -> Dict[str, Any]:
        """The four fields as JSON-ready values."""
        return {"flops": self.flops, "bytes": self.bytes,
                "coll_bytes": dict(self.coll_bytes),
                "coll_count": dict(self.coll_count)}


def flop_sites(cost: Cost) -> Dict[str, Dict[str, float]]:
    """``cost``'s FLOPs by op and site, largest first, as JSON-ready
    values."""
    return {op: {"flops": f, "count": n} for op, (f, n) in
            sorted(cost.flops_by_op.items(), key=lambda kv: -kv[1][0])}


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def by_op(cost: Cost) -> Dict[str, Dict[str, Dict[str, float]]]:
    """``cost``'s collectives by kind and cause, largest bytes first, as
    JSON-ready values."""
    return {kind: {op: {"bytes": b, "count": n} for op, (b, n) in
                   sorted(ops.items(), key=lambda kv: -kv[1][0])}
            for kind, ops in cost.coll_by_op.items()}


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
# the counter itself and the layout helpers: a site is their caller
_SKIP = (os.path.abspath(__file__),
         os.path.join(_PKG, "dist", "sharding.py"))


_TORCH = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep


def _site() -> Tuple[bool, str]:
    """(whether an explicit ``DTensor.redistribute`` / ``full_tensor`` is
    on the stack, the op's site): the innermost function of this package on
    the stack outside the layout helpers, as ``file.py:function``; else,
    inside autograd's engine, ``backward`` and the node it runs
    (``backward MmBackward0``: the gradient of a forward ``mm``); else the
    innermost function outside torch (a caller of this package's
    functions)."""
    f = sys._getframe(2)
    explicit, site, outside = False, None, None
    while f is not None and site is None:
        path, name = f.f_code.co_filename, f.f_code.co_name
        if path.endswith(os.path.join("distributed", "tensor", "_api.py")) \
                and name in ("redistribute", "full_tensor"):
            explicit = True
        elif path.startswith(_PKG) and path not in _SKIP:
            site = f"{os.path.basename(path)}:{name}"
        elif name == "_engine_run_backward":
            break
        elif outside is None and not path.startswith(_TORCH) \
                and path not in _SKIP:
            outside = f"{os.path.basename(path)}:{name}"
        f = f.f_back
    if site is None:
        node = getattr(torch._C, "_current_autograd_node", lambda: None)()
        if node is not None:
            site = f"backward {node.name()}"
    return explicit, site or outside or "backward"


# the namespaces of collective ops: the functional ones, c10d's, and
# DTensor's own all-to-all (a shard moved from one dim to another over a
# mesh dim, on CUDA)
_COLLECTIVES = ("_c10d_functional", "c10d", "_dtensor")


def _kind(name: str):
    # functional names (all_gather_into_tensor), c10d's (allgather_,
    # alltoall_base_, reduce_scatter_tensor_coalesced) and DTensor's
    # (shard_dim_alltoall)
    flat = name.replace("_", "")
    return next((k for k in KINDS if k.replace("_", "") in flat), None)


class _Counter(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self.cost = cost
        self._dtensor, self._fake = DTensor, FakeTensor
        self._flops = flop_registry
        self._trigger = None    # the DTensor op being dispatched

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            # DTensor's collectives for this op, then its local op, come back
            self._trigger = func._overloadpacket
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, self._fake) for t in types):
            return out              # DTensor's shape inference
        packet = func._overloadpacket
        name = packet.__name__
        if packet is self._trigger:
            self._trigger = None
        if name in _FREE or func.is_view:
            return out
        moved = _nbytes((args, kwargs)) + _nbytes(out)
        self.cost.bytes += moved
        if packet in self._flops:
            flops = float(self._flops[packet](*args, **kwargs, out_val=out))
            self.cost.flops += flops
            key = f"{name} @ {_site()[1]}"
            entry = self.cost.flops_by_op.setdefault(key, [0.0, 0])
            entry[0] += flops
            entry[1] += 1
        kind = _kind(name) if func.namespace in _COLLECTIVES else None
        if kind is not None:
            c = self.cost
            n = _nbytes(out)
            c.coll_bytes[kind] = c.coll_bytes.get(kind, 0.0) + n
            c.coll_count[kind] = c.coll_count.get(kind, 0.0) + 1
            explicit, site = _site()
            op = ("redistribute" if explicit else
                  self._trigger.__name__ if self._trigger else "collective")
            key = f"{op} @ {site}"
            entry = c.coll_by_op.setdefault(kind, {}).setdefault(key, [0.0, 0])
            entry[0] += n
            entry[1] += 1
            if n > c.largest[0]:
                c.largest = (float(n), kind, key)
        return out


def analyze(fn: Callable, *args, **kwargs) -> Cost:
    """The cost on this rank of running ``fn(*args, **kwargs)`` once (its
    result is dropped: a caller that needs it keeps it from ``fn``)."""
    cost = Cost()
    with _Counter(cost):
        fn(*args, **kwargs)
    return cost
