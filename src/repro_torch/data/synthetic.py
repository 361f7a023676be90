"""Synthetic datasets shaped like the paper's two scenarios + LM streams."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.encodings.base import SparseCOO


def ffhq_like(shape: Tuple[int, ...] = (256, 3, 128, 128), seed: int = 0,
              dtype=np.uint8) -> np.ndarray:
    """Dense image tensor with realistic spatial correlation (compressible
    like PNG-decoded faces, not iid noise)."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    base = rng.integers(0, 256, (n, c, h // 8, w // 8)).astype(np.float32)
    img = np.repeat(np.repeat(base, 8, axis=2), 8, axis=3)
    # smooth gradients + mild quantized noise: PNG-decoded faces compress
    # moderately (they are not iid noise)
    img += np.linspace(0, 24, w)[None, None, None, :]
    img += rng.normal(0, 2, (n, c, h, w)).round()
    return np.clip(img, 0, 255).astype(dtype)


def uber_like(shape: Tuple[int, ...] = (183, 24, 285, 430),
              nnz_ratio: float = 0.00038, seed: int = 1) -> SparseCOO:
    """Sparse 4-D (day, hour, lat, lon) pickup counts with the real Uber
    data's structure: a compact hot core (Manhattan analog) where a few
    hundred grid cells stay active across a large share of (day, hour)
    slots, plus a popularity long tail. This joint space-time clustering is
    exactly what CSF fiber trees and BSGS time-major blocks exploit."""
    rng = np.random.default_rng(seed)
    total = int(np.prod(shape))
    nnz = int(total * nnz_ratio)
    d, h, la, lo = shape
    # hot core: ~0.15% of the grid, tightly packed around a few hubs
    n_cells = max(32, int(la * lo * 0.0015))
    n_hubs = 6
    hubs = np.stack([rng.integers(la // 8, la - la // 8, n_hubs),
                     rng.integers(lo // 8, lo - lo // 8, n_hubs)], axis=1)
    hub_of = rng.integers(0, n_hubs, n_cells)
    cells = np.stack([
        np.clip(hubs[hub_of, 0] + rng.normal(0, 3, n_cells).astype(int), 0, la - 1),
        np.clip(hubs[hub_of, 1] + rng.normal(0, 3, n_cells).astype(int), 0, lo - 1),
    ], axis=1)
    cells = np.unique(cells, axis=0)
    # zipf-ish popularity: hottest cells get most pickups
    pop = 1.0 / np.arange(1, len(cells) + 1) ** 0.7
    pop /= pop.sum()
    which = rng.choice(len(cells), size=nnz, p=pop)
    day = rng.integers(0, d, nnz)
    hour = (rng.normal(18, 5, nnz).astype(int)) % h
    idx = np.stack([day, hour, cells[which, 0], cells[which, 1]],
                   axis=1).astype(np.int64)
    # dedupe collisions (counts sum, like real pickup counts)
    key = np.ravel_multi_index(idx.T, shape)
    ukey, counts = np.unique(key, return_counts=True)
    uidx = np.stack(np.unravel_index(ukey, shape), axis=1)
    return SparseCOO(uidx, counts.astype(np.float32), shape)


def token_stream(n_samples: int, seq_len: int, vocab: int, seed: int = 2
                 ) -> np.ndarray:
    """Markov-ish token stream (learnable structure, not uniform noise)."""
    rng = np.random.default_rng(seed)
    trans = rng.integers(0, vocab, (256, 8))
    out = np.empty((n_samples, seq_len), np.int32)
    state = rng.integers(0, 256, n_samples)
    for t in range(seq_len):
        pick = rng.integers(0, 8, n_samples)
        out[:, t] = trans[state, pick] % vocab
        state = (state * 31 + out[:, t]) % 256
    return out
