"""block_norms's share of its roofline over the profiled steps: the least time
of its launches (each input byte read once and each output byte written
once, at the H100's 3.35 TB/s; bytes from the operands' shapes by
``yardstick.kernel_bytes``) over their device time, in %."""
from yardstick import peaks


def read(run):
    if run.trace is None or "block_norms" not in run.kernel_bytes:
        return None
    s = run.trace.device_seconds("bench.kernel.block_norms")
    if not s:
        return None
    return 100.0 * run.kernel_bytes["block_norms"] / peaks.HBM_BYTES_PER_S / s
