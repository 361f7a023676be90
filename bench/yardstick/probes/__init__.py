"""The program's kernels the yardstick probes, one module each.

Each ``<kernel>.py`` in this directory is a probe, read by the metric
``<kernel>_roofline``, so a kernel's roofline is added as one new file
(and its metric's reader). A traced run wraps only the probes that its
cell's metrics read, so a probe added for a new cell's kernel leaves the
other cells' runs as they were. Each module defines:

* ``MODULE`` and ``ATTR``: the program's module and the attribute of it
  to wrap (a kernel's ``launch``; the entry points look it up at each
  call, so the wrapper is what the program calls);
* ``note(args, kw, out)``: what to keep of one launch;
* ``least_bytes(noted)``: the fewest bytes that launch must move, every
  input byte read once and every output byte written once (it may read
  what ``note`` kept of the device's tensors: call it after the device
  has finished);
* ``flops(noted)``: the operations it must do; 0 for a memory-bound
  kernel.

The modules import nothing of the program; :class:`..program.Probes`
wraps their targets.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterable

DIR = Path(__file__).resolve().parent
SUFFIX = "_roofline"


def names() -> list:
    """The kernels that have a probe in this directory."""
    return [p.stem for p in sorted(DIR.glob("*.py")) if p.stem != "__init__"]


def read_by(metrics: Iterable[str]) -> Dict[str, ModuleType]:
    """``{kernel: module}`` of the probes that the metrics named read:
    ``<kernel>_roofline`` reads ``<kernel>.py`` where that file exists."""
    have = set(names())
    kernels = [m[:-len(SUFFIX)] for m in metrics if m.endswith(SUFFIX)]
    return {k: importlib.import_module(f"{__name__}.{k}")
            for k in kernels if k in have}
