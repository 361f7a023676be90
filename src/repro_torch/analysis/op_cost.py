"""What one rank's program costs, counted op by op as it runs: the port's
counterpart of ``repro.analysis.hlo_cost``, which walks the compiled SPMD
program of one device.

:func:`analyze` runs ``fn`` under a dispatch mode that sees every aten op
this process executes on plain tensors, forward and backward:

* FLOPs of the matmul-like ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions, attention kernels) at the shapes they run at, from
  ``torch.utils.flop_counter``'s formulas (2 · M · N · K for a matmul);
  elementwise ops count no FLOPs, as the reference counts only dots;
* bytes: the operands plus the results of every op that is not a view or
  an allocation: an upper bound, since nothing is fused;
* collective bytes (the output of each collective) and counts, by kind:
  ``all_gather``, ``all_reduce``, ``reduce_scatter``, ``all_to_all``.

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

from dataclasses import dataclass, field
from typing import Any, Callable, Dict

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

    @property
    def total_coll_bytes(self) -> float:
        """Collective bytes over every kind."""
        return float(sum(self.coll_bytes.values()))

    def as_dict(self) -> Dict[str, Any]:
        """The four fields as JSON-ready values."""
        return {"flops": self.flops, "bytes": self.bytes,
                "coll_bytes": dict(self.coll_bytes),
                "coll_count": dict(self.coll_count)}


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _kind(name: str):
    # functional names (all_gather_into_tensor) and c10d's (allgather_,
    # alltoall_base_, reduce_scatter_tensor_coalesced)
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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented   # DTensor's local ops come back here
        out = func(*args, **kwargs)
        if any(issubclass(t, self._fake) for t in types):
            return out              # DTensor's shape inference
        packet = func._overloadpacket
        name = packet.__name__
        if name in _FREE or func.is_view:
            return out
        moved = _nbytes((args, kwargs)) + _nbytes(out)
        self.cost.bytes += moved
        if packet in self._flops:
            self.cost.flops += float(self._flops[packet](*args, **kwargs,
                                                         out_val=out))
        kind = _kind(name) if func.namespace in ("_c10d_functional", "c10d") \
            else None
        if kind is not None:
            c = self.cost
            c.coll_bytes[kind] = c.coll_bytes.get(kind, 0.0) + _nbytes(out)
            c.coll_count[kind] = c.coll_count.get(kind, 0.0) + 1
        return out


def analyze(fn: Callable, *args, **kwargs) -> Cost:
    """The cost on this rank of running ``fn(*args, **kwargs)`` once (its
    result is dropped: a caller that needs it keeps it from ``fn``)."""
    cost = Cost()
    with _Counter(cost):
        fn(*args, **kwargs)
    return cost
