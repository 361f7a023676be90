"""Device milliseconds per profiled step of the program's forward pass
(span ``train.forward``: the model and the f32 cross-entropy)."""
from yardstick import spans


def read(run):
    return spans.per_step_ms(run, ["train.forward"])
