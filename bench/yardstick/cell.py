"""One run of one cell: set-up, the three checked steps, the timed
window, the profiled steps, the reference and the comparison.

The program's state is built once, driven through its first three steps
by the window's own step call and feed, and handed to the window. Those
steps are the warm-up (every shape the window uses) and the steps the
reference follows.
"""

from __future__ import annotations

import gc
import math
import os
import tempfile
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import program, traffic, weights
from .reference import model as ref_model
from .reference import train as ref_train

CHECK_STEPS = 3


class Clock:
    """Step boundaries: CUDA events on the card's stream, the host clock
    elsewhere (the CPU tests)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def done(self, mark) -> bool:
        return mark.query() if self.cuda else True

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


class Feed:
    """The store's device feed as a step takes it: each call yields the
    loader's next batch split into tokens and labels, and keeps the rows it
    delivered with their sample ids for the check."""

    def __init__(self, loader, seq_len: int):
        self.loader, self.seq_len = loader, seq_len
        self.it = iter(loader)
        self.kept: List = []

    def __call__(self) -> Dict[str, torch.Tensor]:
        b = next(self.it)
        self.kept.append((b["data"], np.asarray(b["samples"])))
        return traffic.split_batch(b["data"], self.seq_len)


class Setup:
    """What a run drives: the program's step and its train state, the
    feed, the loader and the token table. The state lives here only: each
    step's result replaces it, so the residuals a compressed step replaces
    are freed at once."""

    def __init__(self, step: Callable, state, feed: Feed, loader,
                 table: np.ndarray, workdir: tempfile.TemporaryDirectory):
        self.step, self.state, self.feed = step, state, feed
        self.loader, self.table, self.workdir = loader, table, workdir

    def advance(self, batch) -> Dict[str, torch.Tensor]:
        """One step of the program on ``batch``: its metrics."""
        self.state, metrics = self.step(self.state, batch)
        return metrics

    def close(self) -> None:
        """Drop the state, stop the loader, remove the table."""
        self.state = None
        self.loader.close()
        self.workdir.cleanup()


def _seconds(times: Dict[str, float], key: str, t0: float) -> float:
    now = time.perf_counter()
    times[key] = times.get(key, 0.0) + now - t0
    return now


def setup(cell, seed: int, device: torch.device, times: Dict[str, float],
          make_step: Optional[Callable] = None) -> Setup:
    """Kernels, weights from the seed, the token table in a store under
    ``TMPDIR``, the loader, the step and its state. ``make_step`` replaces
    the program's step (the tests' planted faults)."""
    arch, mix = cell.config["arch"], cell.mix
    t = time.perf_counter()
    cfg = program.arch_config(arch)
    step = (make_step or program.make_step)(mix, cfg)
    t = _seconds(times, "program", t)
    if device.type == "cuda":
        times["kernels_built"] = len(program.build_kernels(mix))
    t = _seconds(times, "kernels", t)
    params = weights.draw(arch, seed, device)
    state = program.make_state(mix, params)
    del params
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = _seconds(times, "weights", t)
    table = traffic.token_table(seed, mix, arch["vocab_size"])
    workdir = tempfile.TemporaryDirectory(prefix="bench-table-")
    store, tid = program.open_table(workdir.name, table, device)
    loader = program.open_loader(store, tid, mix, seed, device)
    feed = Feed(loader, mix["seq_len"])
    t = _seconds(times, "table", t)
    return Setup(step, state, feed, loader, table, workdir)


def _norm_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| in f32, about ``1 << 24`` elements at a time."""
    if a.ndim == 0:
        return float((a.float() - b.float()).abs())
    rows = max(1, (1 << 24) // max(1, a[0].numel()))
    return math.sqrt(sum(float((x.float() - y.float()).square().sum())
                         for x, y in zip(a.split(rows), b.split(rows))))


def check_steps(s: Setup, cell, seed: int, device: torch.device) -> Dict:
    """The first three steps through the window's call and feed, read
    as the optimizer's state keeps them: each step's loss, each leaf's
    first gradient (m / (1 - b1) after one step; for a compressed step also
    its non-zero tiles and the residual the step keeps), each leaf's change
    after three steps."""
    mix, arch = cell.mix, cell.config["arch"]
    b1 = mix["optimizer"]["b1"]
    block = tuple(mix.get("block", (8, 128)))
    losses, out = [], {}
    for i in range(CHECK_STEPS):
        losses.append(s.advance(s.feed())["loss"])
        if i == 0:
            moments = program.first_moments(s.state)
            out["grad_norms"] = {n: float(m.norm()) / (1 - b1)
                                 for n, m in moments}
            if mix["step"] == "bsgs":
                out["tiles_sent"] = {n: ref_train.nonzero_tiles(m, block)
                                     for n, m in moments}
                out["residual_norms"] = {n: float(r.norm()) for n, r in
                                         program.residual_leaves(s.state)}
            del moments
    params = dict(program.param_leaves(s.state))
    out["change_norms"] = {n: _norm_diff(params[n], w0)
                           for n, w0 in weights.iter_draw(arch, seed, device)}
    out["losses"] = [float(x) for x in losses]
    return out


class Window(NamedTuple):
    steps: int
    tokens_per_step: int
    start_ms: float
    ends_ms: List[float]
    loader_wait_s: List[float]
    failed: int


def window(s: Setup, seconds: float, clock: Clock, tokens: int) -> Window:
    """Steps back to back until the first step that ends ``seconds`` after
    the window's start; the host waits on no step's metrics inside. Steps
    already dispatched after that one run on, outside the window."""
    marks, waits, losses = [], [], []
    start = clock.mark()
    last, seen = None, 0
    while last is None:
        t = time.perf_counter()
        batch = s.feed()
        waits.append(time.perf_counter() - t)
        losses.append(s.advance(batch)["loss"])
        marks.append(clock.mark())
        while seen < len(marks) and clock.done(marks[seen]):
            if clock.ms(start, marks[seen]) >= seconds * 1e3:
                last = seen
                break
            seen += 1
    clock.sync()
    n = last + 1
    ends = [clock.ms(start, m) for m in marks[:n]]
    bad = int((~torch.isfinite(torch.stack(losses[:n]).float())).sum())
    return Window(steps=n, tokens_per_step=tokens, start_ms=0.0,
                         ends_ms=ends, loader_wait_s=waits[:n], failed=bad)


def profiled_steps(s: Setup, n: int, clock: Clock, probes):
    """``n`` steps (plus one that starts the card from idle) under
    ``torch.profiler`` with the benchmark's host ranges, exported as a
    chrome trace under ``TMPDIR`` and read back (a :class:`Trace`)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from .trace import Trace
    acts = [ProfilerActivity.CPU]
    if clock.cuda:
        acts.append(ProfilerActivity.CUDA)
    clock.sync()
    with probes.active(), profile(activities=acts) as prof:
        marks = []
        for _ in range(n + 1):
            with record_function("bench.loader_wait"):
                batch = s.feed()
            with record_function("bench.step"):
                s.advance(batch)
            with record_function("bench.event_read"):
                marks.append(clock.mark())
                clock.done(marks[-1])
        with record_function("bench.event_read"):
            clock.sync()
    with tempfile.TemporaryDirectory(prefix="bench-trace-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        return Trace.load(path)


@contextmanager
def exact_f32():
    """f32 matmuls without TF32 while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def reference_readings(cell, seed: int, table: np.ndarray, samples: List,
                       device: torch.device, mm=ref_model.matmul) -> Dict:
    """The reference's three steps from the weights drawn again from the
    seed, on the table's rows that the checked steps took."""
    t = cell.mix["seq_len"]
    rows = torch.from_numpy(table).to(device)
    batches = [(rows[torch.as_tensor(ids, device=device)][:, :t],
                rows[torch.as_tensor(ids, device=device)][:, 1:])
               for ids in samples]
    w0 = weights.draw(cell.config["arch"], seed, device)
    with exact_f32():
        return ref_train.run(cell.config["arch"], cell.mix, w0, batches, mm)


def _gap(got: float, want: float, floor: float) -> float:
    return abs(got - want) / max(abs(want), floor, 1e-30)


def compare(prog: Dict, ref: Dict, cell) -> Dict[str, float]:
    """The numbers ``correct`` compares (see ``PERF.md``). Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the gradient, residual and change
    gaps; of the others:

    * ``loss_gap``: the largest relative gap of a checked step's loss;
    * ``grad_gap``: the largest gap between the norms of a leaf's first
      gradient, over the reference's norm of that leaf;
    * ``residual_gap`` (compressed steps): the same of the residual the
      first step keeps (what it did not send);
    * ``change_gap``: the largest gap between the norms of a leaf's change
      after the three steps, over the reference's norm of that leaf's
      change or of the median leaf's, whichever is larger (norm scales at
      1.0 do not move in bf16);
    * ``tiles_sent_gap`` (compressed steps): the largest difference, over
      the leaves, in the count of tiles the first step sent.
    """
    out = {"loss_gap": max(_gap(a, b, 0.0) for a, b in
                           zip(prog["losses"], ref["losses"]))}
    gref = ref["grad_norms"]
    gmed = float(np.median(list(gref.values())))
    counted = [k for k, g in gref.items() if g >= 1e-3 * gmed]
    out["grad_gap"] = max(_gap(prog["grad_norms"][k], gref[k], 0.0)
                          for k in counted)
    if "residual_norms" in ref:
        out["residual_gap"] = max(
            _gap(prog["residual_norms"][k], ref["residual_norms"][k], 0.0)
            for k in counted)
    cmed = float(np.median([ref["change_norms"][k] for k in counted]))
    out["change_gap"] = max(_gap(prog["change_norms"][k], ref["change_norms"][k],
                                 cmed) for k in counted)
    if "tiles_sent" in ref:
        out["tiles_sent_gap"] = float(max(
            abs(prog["tiles_sent"][k] - n) for k, n in ref["tiles_sent"].items()))
    return out


def batch_mismatch(feed: Feed, table: np.ndarray, device: torch.device) -> int:
    """Tokens of every batch the loader delivered that differ from the
    table's rows at the batch's sample ids."""
    rows = torch.from_numpy(table).to(device)
    bad = 0
    for data, ids in feed.kept:
        want = rows[torch.as_tensor(ids, device=device)]
        bad += int((data != want).sum())
    return bad


def release() -> None:
    """Return the memory of dropped tensors to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
