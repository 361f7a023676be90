"""Device milliseconds per profiled step of the checkpointed super-blocks'
recompute: the spans ``model.superblock`` opened inside the backward
pass."""
from yardstick import spans


def read(run):
    return spans.per_step_ms(run, ["model.superblock"], keep=lambda r: r.backward)
