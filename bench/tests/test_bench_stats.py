"""Window statistics and trace reductions."""

import pytest

from yardstick import stats
from yardstick.trace import Trace


def test_window_rate_and_p90_over_every_step():
    ends = [100.0 * i for i in range(1, 101)]               # 100 steps of 100 ms
    assert stats.window_rate(2048, 0.0, ends) == pytest.approx(2048 / 0.1)
    gaps = stats.step_gaps_ms(0.0, ends)
    assert len(gaps) == 100 and stats.percentile(gaps, 90) == pytest.approx(100.0)
    # a loader stall of 2 s before step 50: both move
    stalled = [e + (2000.0 if i >= 49 else 0.0) for i, e in enumerate(ends)]
    assert stats.window_rate(2048, 0.0, stalled) < 2048 / 0.1 * 0.9
    many = [e + 500.0 * sum(1 for j in range(0, 100, 9) if j <= i)
            for i, e in enumerate(ends)]                     # 12 slow steps
    assert stats.percentile(stats.step_gaps_ms(0.0, many), 90) > 500.0


def test_percentile_interpolates():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile([5], 90) == 5


def test_union_of_overlapping_intervals():
    iv = [(0, 4), (2, 6), (5, 7), (10, 12), (11, 11.5)]
    assert stats.merge(iv) == [(0, 7), (10, 12)]
    assert stats.busy(iv, 0, 20) == 9
    assert stats.busy(iv, 3, 11) == 5
    assert stats.gaps(iv, 0, 20) == [(7, 10), (12, 20)]
    # summing the intervals would count 3 + 1 + 0.5 overlapping units twice
    assert sum(b - a for a, b in iv) > stats.busy(iv, 0, 20)


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_trace_ranges_idle_and_kernels():
    events = [
        _ev("user_annotation", "bench.step", 0, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=1),
        _ev("kernel", "a", 20, 30, tid=7, correlation=1),
        _ev("user_annotation", "bench.step", 100, 65),
        _ev("user_annotation", "bench.compress", 110, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 115, 1, correlation=2),
        _ev("kernel", "b", 120, 40, tid=7, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 1, correlation=3),
        _ev("kernel", "c", 140, 30, tid=7, correlation=3),     # overlaps b
        _ev("user_annotation", "bench.loader_wait", 165, 45),
        _ev("cuda_runtime", "cudaLaunchKernel", 190, 1, tid=2, correlation=4),
        _ev("kernel", "d", 200, 10, tid=7, correlation=4),
    ]
    tr = Trace(events)
    assert tr.span() == (50, 210)            # after the first step's device work
    assert tr.busy_seconds() == pytest.approx((170 - 120 + 10) / 1e6)
    assert tr.device_seconds("bench.compress") == pytest.approx(40e-6)
    assert tr.device_seconds("bench.adamw") is None
    gaps = tr.idle_gaps()
    assert gaps[0] == ["bench.step", pytest.approx(70e-6)]
    assert gaps[1] == ["bench.loader_wait", pytest.approx(30e-6)]
    assert tr.top_ops(2) == [["b", pytest.approx(40e-6)], ["c", pytest.approx(30e-6)]]
