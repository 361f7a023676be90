"""Device milliseconds per profiled step of the program's
``compressed_grad_mean`` (span ``compress``), from the events inside it:
the inside counterpart of ``compress_ms``."""
from yardstick import spans


def read(run):
    return spans.per_step_ms(run, ["compress"])
