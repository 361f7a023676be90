"""The model families the yardstick knows, one module each.

A configuration's ``arch`` names its ``family``; :func:`load` finds
``<family>.py`` in this directory, so a family is added as one new file.
Each module defines:

* ``layout(a) -> List[Leaf]``: every leaf of the parameter tree, sorted by
  name (the order in which the program's trees flatten);
* ``loss(w, a, tokens, labels, mm) -> Tensor``: the plain reference's
  forward pass and mean cross-entropy in f32, in plain PyTorch, importing
  nothing of the program and nothing of JAX;
* ``param_count(a)``, ``applied_params(a)`` (parameters a token passes
  through: a shared block at each application, only the experts a token
  is routed to) and ``attention_flops(a, b, t)``.

The pieces families share stay where they were: the leaf helpers in
:mod:`..weights`, the layers in :mod:`..reference.model`, the parameter
arithmetic in :mod:`..accounting`.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType

DIR = Path(__file__).resolve().parent


def load(a: dict) -> ModuleType:
    """The module of the family of ``a`` (a configuration's ``arch``)."""
    family = a["family"]
    path = DIR / f"{family}.py"
    if not family.isidentifier() or not path.is_file():
        raise ValueError(f"no module for family {family!r}: looked for {path}")
    return importlib.import_module(f"{__name__}.{family}")
