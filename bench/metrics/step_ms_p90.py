"""90th percentile of the gaps between consecutive step-end CUDA events,
over every step of the window (the first from the window's start)."""
from yardstick import stats


def read(run):
    w = run.window
    return stats.percentile(stats.step_gaps_ms(w.start_ms, w.ends_ms), 90)
