"""1 - (union of device-busy intervals) / the profiled steps' span, in %:
from the end of the first profiled step's device work to the last
device op's end."""


def read(run):
    if run.trace is None:
        return None
    span, busy = run.trace.span(), run.trace.busy_seconds()
    if span is None or busy is None:
        return None
    return 100.0 * (1.0 - busy / ((span[1] - span[0]) / 1e6))
