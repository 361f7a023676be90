"""Reductions from step events and trace intervals to numbers."""

from __future__ import annotations

import statistics
from typing import List, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) by linear interpolation between
    the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def step_gaps_ms(start_ms: float, ends_ms: Sequence[float]) -> List[float]:
    """Gaps between consecutive step ends, the first from the window's
    start: every step of the window has one."""
    out, prev = [], start_ms
    for e in ends_ms:
        out.append(e - prev)
        prev = e
    return out


def window_rate(tokens_per_step: int, start_ms: float,
                ends_ms: Sequence[float]) -> float:
    """Tokens of every step of the window over the window's time, from
    its start to the last step's end (per second)."""
    span_s = (ends_ms[-1] - start_ms) / 1e3
    return tokens_per_step * len(ends_ms) / span_s


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """``intervals`` cut to [lo, hi], empty ones dropped."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def busy(intervals: Sequence[Interval], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    return sum(b - a for a, b in merge(clip(intervals, lo, hi)))


def gaps(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The idle stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def spread(values: Sequence[float]) -> float:
    """Interquartile range over the median (``statistics.quantiles``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
