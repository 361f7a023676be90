"""adamw's share of its roofline over the profiled steps: the least time of
its launches (the gradient's distinct elements read once, the param and
both f32 moments read and written once, at the H100's 3.35 TB/s; bytes
from the operands by ``yardstick/probes/adamw.py``) over their device
time, in %."""
from yardstick import roofline


def read(run):
    return roofline.share(run, "adamw")
