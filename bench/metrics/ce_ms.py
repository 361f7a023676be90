"""Device milliseconds per profiled step of the f32 cross-entropy over the
head: its forward (span ``train.loss``) plus its backward, chunks'
recompute included (span ``train.loss.backward``)."""
from yardstick import spans


def read(run):
    return spans.per_step_ms(run, ["train.loss", "train.loss.backward"])
