"""Tokens of every step of the window over the window's time, from the
CUDA event before its first step to the one after its last."""
from yardstick import stats


def read(run):
    w = run.window
    return stats.window_rate(w.tokens_per_step, w.start_ms, w.ends_ms)
