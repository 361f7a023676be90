"""The system under test, ``repro_torch``, as the benchmark drives it:
its train steps, its store and its loader, and the names its modules
give the layers. This module and :mod:`.spans`, which reads the program's
own spans, are the benchmark's only modules that import the program; the
reference, the families, the probes and the arithmetic never do.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch

from . import probes as kernel_probes


def arch_config(arch: dict):
    """The program's ``ArchConfig`` of a configuration file's ``arch``."""
    from repro_torch.models.config import ArchConfig
    return ArchConfig(**arch)


def check_layout(cfg, layout) -> None:
    """Raise unless the program's parameter tree has exactly the leaves of
    :func:`yardstick.weights.layout`, in the same order, shapes and dtypes
    (the weights the benchmark draws are handed over by name). The tests
    call it; a run does not, since the program's meta init costs seconds
    of set-up and a tree that differs fails the run or its comparison."""
    from repro_torch.models import transformer
    from repro_torch.tree import leaves
    got = [(n, tuple(t.shape), t.dtype) for n, t in
           leaves(transformer.init_params(cfg, device="meta"))]
    want = [(leaf.name, leaf.shape, leaf.dtype) for leaf in layout]
    if got != want:
        raise RuntimeError(f"the program's parameter tree differs from the "
                           f"benchmark's layout: {got} != {want}")


def nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a/b": x}`` as ``{"a": {"b": x}}``."""
    out: Dict[str, Any] = {}
    for name, x in flat.items():
        *path, last = name.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[last] = x
    return out


def build_kernels(mix: dict) -> Dict[str, float]:
    """Build (first run in a checkout) or find the CUDA libraries a mix
    launches: ``{library: seconds}`` of those built now."""
    if mix["step"] != "bsgs":
        return {}
    from repro_torch.kernels import _build
    names = ("block_norms", "block_gather", "block_scatter")
    built = _build.build(names)
    for name in names:
        _build.load(name)
    return built


def make_state(mix: dict, params: Dict[str, torch.Tensor]):
    """The program's train state over the benchmark's weights (the tensors
    themselves: the step updates them in place)."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer
    from repro_torch.tree import tree_map
    tree = nest(params)
    step = torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)
    if mix["step"] == "bsgs":
        podded = tree_map(lambda x: x.unsqueeze(0), tree)
        return trainer.CompressedTrainState(
            params=podded, opt=opt.init(podded),
            residual=tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                    device=x.device), podded),
            step=step)
    return trainer.TrainState(params=tree, opt=opt.init(tree), step=step)


def make_step(mix: dict, cfg) -> Callable:
    """The program's step for ``mix``: ``step(state, batch) -> (state,
    metrics)`` over ``{"tokens", "labels"}`` (B, T) batches."""
    from repro_torch.train import grad_compress, trainer
    from repro_torch.train import optimizer as opt
    ocfg = opt.OptConfig(**mix["optimizer"])
    if mix["step"] == "bsgs":
        if tuple(mix["block"]) != tuple(grad_compress.DEFAULT_BLOCK):
            raise ValueError(f"the program's block is {grad_compress.DEFAULT_BLOCK}")
        inner = trainer.make_compressed_train_step(cfg, ocfg, ratio=mix["ratio"])

        def step(state, batch):
            return inner(state, {k: v[None] for k, v in batch.items()})
        return step
    if mix["step"] == "plain":
        return trainer.make_train_step(cfg, ocfg)
    raise ValueError(f"unknown step kind {mix['step']!r}")


def param_leaves(state) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of the state's params, without the pod dim."""
    from repro_torch.tree import leaves
    pod = hasattr(state, "residual")
    return [(n, t[0] if pod else t) for n, t in leaves(state.params)]


def first_moments(state) -> List[Tuple[str, torch.Tensor]]:
    """(name, m) of the state's first moments, without the pod dim."""
    from repro_torch.tree import leaves
    pod = hasattr(state, "residual")
    return [(n, t[0] if pod else t) for n, t in leaves(state.opt.m)]


def residual_leaves(state) -> List[Tuple[str, torch.Tensor]]:
    """(name, r) of a compressed state's residuals, without the pod dim."""
    from repro_torch.tree import leaves
    return [(n, t[0]) for n, t in leaves(state.residual)]


def open_table(root: str, table, device) -> Tuple[Any, str]:
    """A port store for ``device`` under ``root`` holding ``table``
    (numpy) as FTSF rows: (store, tensor id)."""
    from repro_torch.core import DeltaTensorStore
    from repro_torch.data.pipeline import write_token_dataset
    from repro_torch.lake import LocalFSObjectStore
    store = DeltaTensorStore(LocalFSObjectStore(root), "datasets",
                             device=str(device))
    return store, write_token_dataset(store, table, tensor_id="tokens")


def open_loader(store, tid: str, mix: dict, seed: int, device):
    """The store's device feed: ``StreamLoader(..., device=device)``."""
    from repro_torch.data.stream import StreamLoader
    return StreamLoader(store, tid, batch_size=mix["rows"], seed=seed,
                        window=mix["loader_window"], device=str(device))


# -- traced runs: ranges around the program's layers ---------------------------

class Probes:
    """While active, wraps the program's compressor and optimizer entry
    points and each probed kernel's target (``yardstick/probes/``) in
    ``record_function`` ranges (``bench.compress``, ``bench.adamw``,
    ``bench.kernel.<name>``), notes what each kernel launch's probe keeps
    for its byte and operation counts, and notes each tile gather of the
    compressor's top-k (``ops.block_gather``, on the card or not: the
    leaf's 2-D shape, its tile and the ids sent) for the payload's bytes.
    The kernels probed are those that ``metrics``, the names of the cell's
    per-layer metrics, read. No argument or result is changed. Used only
    around profiled steps."""

    def __init__(self, metrics: Iterable[str] = ()):
        self.kernels = kernel_probes.read_by(metrics)
        self.launches: Dict[str, List[Tuple]] = {k: [] for k in self.kernels}
        self.gathers: List[Tuple] = []
        self.compress_stats: List[Dict[str, int]] = []

    @contextlib.contextmanager
    def active(self):
        from repro_torch.kernels import ops
        from repro_torch.train import grad_compress, optimizer
        undo = []

        def wrap(mod, attr, label, note=None):
            orig = getattr(mod, attr)

            def wrapped(*args, **kw):
                with (torch.profiler.record_function(label) if label
                      else contextlib.nullcontext()):
                    out = orig(*args, **kw)
                if note is not None:
                    note(args, kw, out)
                return out
            setattr(mod, attr, wrapped)
            undo.append((mod, attr, orig))

        def keep(name, probe):
            return lambda a, kw, out: self.launches[name].append(
                probe.note(a, kw, out))

        wrap(grad_compress, "compressed_grad_mean", "bench.compress",
             lambda a, kw, out: self.compress_stats.append(
                 {k: out[2][k] for k in ("sent_bytes", "dense_bytes")}))
        wrap(optimizer, "update", "bench.adamw")
        wrap(ops, "block_gather", None,
             lambda a, kw, out: self.gathers.append(
                 (tuple(a[0].shape), tuple(a[2]), a[1].numel())))
        for name, probe in self.kernels.items():
            wrap(importlib.import_module(probe.MODULE), probe.ATTR,
                 f"bench.kernel.{name}", keep(name, probe))
        try:
            yield self
        finally:
            for mod, attr, orig in reversed(undo):
                setattr(mod, attr, orig)

    def kernel_bytes(self) -> Dict[str, int]:
        """Least bytes of every noted launch, summed per kernel that
        launched (reads the ids of gathers and scatters: call after the
        device has finished)."""
        return {k: sum(map(self.kernels[k].least_bytes, noted))
                for k, noted in self.launches.items() if noted}

    def kernel_flops(self) -> Dict[str, int]:
        """Operations of every noted launch, summed per kernel that
        launched."""
        return {k: sum(map(self.kernels[k].flops, noted))
                for k, noted in self.launches.items() if noted}
