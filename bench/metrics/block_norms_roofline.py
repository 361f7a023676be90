"""block_norms's share of its roofline over the profiled steps: the least time
of its launches (each input byte read once and each output byte written
once, at the H100's 3.35 TB/s; bytes from the operands' shapes by
``yardstick/probes/block_norms.py``) over their device time, in %."""
from yardstick import roofline


def read(run):
    return roofline.share(run, "block_norms")
