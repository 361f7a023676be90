"""Device milliseconds per profiled step of the program's AdamW update
(span ``optimizer.update``): the inside counterpart of ``adamw_ms``."""
from yardstick import spans


def read(run):
    return spans.per_step_ms(run, ["optimizer.update"])
