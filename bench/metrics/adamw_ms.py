"""Device milliseconds per profiled step of the ops launched inside the
program's ``optimizer.update``."""


def read(run):
    if run.trace is None:
        return None
    s = run.trace.device_seconds("bench.adamw")
    return None if s is None else 1e3 * s / len(run.trace.ranges["bench.step"])
