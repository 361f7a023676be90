"""A probed kernel's share of its roofline over the profiled steps: the
least time of its launches, the larger of their least bytes
(``yardstick/probes/<kernel>.py``) at the H100's HBM bandwidth and their
operations at its dense bf16 peak, over the device time of the ops
launched inside its ``bench.kernel.<kernel>`` ranges, in %."""

from __future__ import annotations

from typing import Optional

from . import peaks


def share(run, name: str) -> Optional[float]:
    """``name``'s share in %; None where it did not run in the profiled
    steps (no trace, no launch noted, or no device time)."""
    if run.trace is None or name not in run.kernel_bytes:
        return None
    s = run.trace.device_seconds(f"bench.kernel.{name}")
    if not s:
        return None
    least = max(run.kernel_bytes[name] / peaks.HBM_BYTES_PER_S,
                run.kernel_flops.get(name, 0) / peaks.BF16_FLOPS)
    return 100.0 * least / s
