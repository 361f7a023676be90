"""Host milliseconds per profiled step from the loader's taking a request
to its handing over the batch (span ``loader.next``): the inside
counterpart of ``loader_wait_ms``."""
from yardstick import spans


def read(run):
    return spans.per_step_ms(run, ["loader.next"], device=False)
