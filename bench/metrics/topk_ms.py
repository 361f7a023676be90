"""Device milliseconds per profiled step of the compressor's top-k: the
stable sort of the tile norms, once per leaf and pod (span
``compress.select``)."""
from yardstick import spans


def read(run):
    return spans.per_step_ms(run, ["compress.select"])
