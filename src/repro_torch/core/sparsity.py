"""Sparsity policy (paper §IV.B): the 10 % rule of thumb.

Tensors whose non-zero fraction is below ``SPARSE_THRESHOLD`` get a sparse
encoding; everything else goes to FTSF (plain chunked). The threshold is a
config knob because the paper frames it as an application-specific
time/space trade-off.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from .encodings.base import SparseCOO

SPARSE_THRESHOLD = 0.10
# FROSTT-style heavy sparsity where per-element COO beats block formats
VERY_SPARSE_THRESHOLD = 1e-4


def density(tensor: Any) -> float:
    """Non-zero fraction in [0, 1] (0.0 for empty tensors)."""
    if isinstance(tensor, SparseCOO):
        return tensor.density
    x = np.asarray(tensor)
    total = x.size
    return (np.count_nonzero(x) / total) if total else 0.0


def choose_layout(tensor: Any, *, threshold: float = SPARSE_THRESHOLD,
                  prefer: Optional[str] = None) -> str:
    """Paper default policy: FTSF for general tensors, BSGS for sparse.

    BSGS is the paper's recommendation for sparse read paths (best Cr and
    read times, Figs. 13/15/16); callers that are write-bound can pass
    ``prefer='csf'`` (fastest writes, Fig. 14).
    """
    if prefer is not None:
        return prefer
    d = density(tensor)
    if d > threshold:
        return "ftsf"
    return "bsgs"
