"""Model FLOPs of the window's steps (6 N D plus attention, the frozen
arithmetic of ``yardstick.accounting``) over the window's time and the
H100's dense bf16 peak, in %."""
from yardstick import accounting, peaks


def read(run):
    w, mix = run.window, run.mix
    flops = accounting.train_step_flops(run.arch, mix["rows"], mix["seq_len"])
    seconds = (w.ends_ms[-1] - w.start_ms) / 1e3
    return 100.0 * flops * w.steps / seconds / peaks.BF16_FLOPS
