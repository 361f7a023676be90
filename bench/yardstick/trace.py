"""Reading a ``torch.profiler`` chrome trace of a few profiled steps.

Device operations are the events of categories ``kernel``, ``gpu_memcpy``
and ``gpu_memset``; each carries the correlation id of the runtime call
that launched it, whose host thread and time place it inside the
benchmark's ranges (``record_function`` labels ``bench.*``). Host and
device times share one clock in the trace (microseconds).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from . import stats

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = ("cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self, events: Iterable[dict]):
        self.device: List[Tuple[float, float, str, Optional[int]]] = []
        self.ranges: Dict[str, List[Tuple[object, float, float]]] = \
            defaultdict(list)
        self.launch: Dict[int, Tuple[object, float]] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts = e.get("cat", ""), float(e.get("ts", 0.0))
            end = ts + float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE:
                self.device.append((ts, end, e.get("name", "?"),
                                    args.get("correlation")))
            elif cat in LAUNCH and "correlation" in args:
                self.launch[args["correlation"]] = (e.get("tid"), ts)
            elif cat == "user_annotation" and str(e.get("name", "")).startswith("bench."):
                self.ranges[e["name"]].append((e.get("tid"), ts, end))
        self.device.sort()

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def ops_in(self, label: str, same_thread: bool = True):
        """Device ops launched inside a range named ``label`` (on the
        range's own host thread, unless ``same_thread`` is false)."""
        spans = self.ranges.get(label, [])
        if not spans:
            return []
        out = []
        for op in self.device:
            at = self.launch.get(op[3])
            if at is None:
                continue
            tid, ts = at
            if any(a <= ts <= b and (not same_thread or t == tid)
                   for t, a, b in spans):
                out.append(op)
        return out

    def device_seconds(self, label: str) -> Optional[float]:
        """Summed device time of the ops launched inside ``label``; None
        where no such range was recorded or it launched nothing."""
        ops = self.ops_in(label)
        if not ops:
            return None
        return sum(b - a for a, b, _, _ in ops) / 1e6

    def span(self) -> Optional[Tuple[float, float]]:
        """The traced steps' span: from the end of the device work of the
        first profiled step (which starts from an idle card) to the end of
        the last device op."""
        steps = sorted(self.ranges.get("bench.step", []), key=lambda r: r[1])
        if len(steps) < 2 or not self.device:
            return None
        first = steps[0]
        mine = [b for a, b, _, c in self.device
                if c in self.launch and first[1] <= self.launch[c][1] <= first[2]]
        lo = max(mine) if mine else first[2]
        hi = max(b for _, b, _, _ in self.device)
        return (lo, hi) if hi > lo else None

    def busy_seconds(self) -> Optional[float]:
        sp = self.span()
        if sp is None:
            return None
        return stats.busy([(a, b) for a, b, _, _ in self.device], *sp) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device ops (by name) with most device time in the
        span: [[name, seconds], ...]."""
        sp = self.span()
        if sp is None:
            return []
        total: Dict[str, float] = defaultdict(float)
        for a, b, name, _ in self.device:
            for x, y in stats.clip([(a, b)], *sp):
                total[name[:160]] += (y - x) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest idle stretches of the span, each named by the
        benchmark's host range it began in: [[name, seconds], ...]."""
        sp = self.span()
        if sp is None:
            return []
        host = [(a, b, name) for name in ("bench.loader_wait", "bench.step",
                                          "bench.event_read")
                for _, a, b in self.ranges.get(name, [])]
        out = []
        for a, b in stats.gaps([(x, y) for x, y, _, _ in self.device], *sp):
            inside = [name for x, y, name in host if x <= a <= y]
            out.append([inside[0] if inside else "bench.between", (b - a) / 1e6])
        return sorted(out, key=lambda g: -g[1])[:n]
