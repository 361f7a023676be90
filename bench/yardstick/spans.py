"""The program's own spans (``repro_torch.obs``) as milliseconds per
profiled step.

The program records spans only while a profiler records, so what it holds
after a traced run are the profiled steps: the last ``profile_steps`` + 1
``train.step`` numbers. Each number is taken over those steps after the
first, which starts the card from idle (as ``Trace.span`` treats it). A
span's device interval comes from the pair of CUDA events the program
records around it (on the CPU, its host duration). Imported lazily: a
checkout whose program has no ``repro_torch.obs`` reads None, as does a
run that recorded no such span.
"""

from __future__ import annotations

import importlib
from typing import Callable, Iterable, List, Optional

STEP = "train.step"


def records() -> List:
    """The spans the program holds; none where it has no span module."""
    try:
        obs = importlib.import_module("repro_torch.obs")
    except ImportError:
        return []
    return obs.spans()


def per_step_ms(run, names: Iterable[str], *, device: bool = True,
                keep: Callable = lambda r: True) -> Optional[float]:
    """Mean over the profiled steps after the first of each step's summed
    milliseconds (device interval, or host with ``device=False``) of the
    spans named in ``names`` that ``keep`` accepts; None where no such
    span was recorded in those steps."""
    if run.trace is None:
        return None
    names = set(names)
    held = records()
    steps = sorted({r.step for r in held if r.name == STEP})
    steps = steps[-(run.mix["profile_steps"] + 1):][1:]
    if not steps:
        return None
    total = dict.fromkeys(steps, 0.0)
    found = False
    for r in held:
        if r.name in names and r.step in total and keep(r):
            total[r.step] += r.device_ms() if device else r.host_ms()
            found = True
    return sum(total.values()) / len(total) if found else None
