"""Device milliseconds per profiled step of the program's backward pass
(span ``train.backward``: the super-blocks' recompute and the
cross-entropy's backward included)."""
from yardstick import spans


def read(run):
    return spans.per_step_ms(run, ["train.backward"])
