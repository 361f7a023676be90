"""Bytes one pod's BSGS payload sends over the dense f32 bytes of its
gradient, from the tile gathers of the compressor's top-k in the profiled
steps (each leaf's 2-D shape, its tile and the number of ids sent) by the
frozen arithmetic of ``yardstick.wire``."""
from yardstick import wire


def read(run):
    gathers = run.probes.gathers
    if not gathers:
        return None
    sent = sum(wire.payload_bytes(k, block) for _, block, k in gathers)
    dense = sum(wire.dense_bytes(shape) for shape, _, _ in gathers)
    return sent / dense
