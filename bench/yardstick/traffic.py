"""The general traffic generator: a token table of packed rows.

A mix file (``bench/traffic/<mix>.json``) gives the step kind, the batch
(``rows`` of ``seq_len`` tokens), the Zipf exponent, the table's size in
rows, the compressor's ratio and block, the loader's window and the
optimizer's hyper-parameters. :func:`token_table` draws the table from the
run's seed: every seed gives the same sizes, only the ids differ.
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for ``stream`` of ``seed`` (any non-negative int)."""
    return np.random.default_rng([int(seed), int(stream)])


def zipf_ids(rng: np.random.Generator, n: int, vocab: int,
             s: float) -> np.ndarray:
    """``n`` int32 ids in [0, vocab): rank r in 1..vocab drawn with
    probability proportional to r ** -s, each rank mapped to an id by a
    seeded permutation of the vocabulary (so frequent ids are spread over
    the embedding's rows)."""
    weights = np.arange(1, vocab + 1, dtype=np.float64) ** -float(s)
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    ranks = np.searchsorted(cdf, rng.random(n), side="right")
    ranks = np.minimum(ranks, vocab - 1)
    perm = rng.permutation(vocab).astype(np.int32)
    return perm[ranks]


def token_table(seed: int, mix: dict, vocab: int) -> np.ndarray:
    """(table_rows, seq_len + 1) int32: packed rows of Zipf ids. A row
    holds ``seq_len + 1`` tokens, so a step's tokens are its first
    ``seq_len`` and its labels the next-token shift, every position
    labelled."""
    rows, t = int(mix["table_rows"]), int(mix["seq_len"])
    ids = zipf_ids(rng_for(seed, 1), rows * (t + 1), vocab, mix["zipf_s"])
    return ids.reshape(rows, t + 1)


def split_batch(data, seq_len: int):
    """``{"tokens", "labels"}`` views of (B, seq_len + 1) rows."""
    if data.shape[-1] != seq_len + 1:
        raise ValueError(f"rows of {data.shape[-1]} tokens, want {seq_len + 1}")
    return {"tokens": data[:, :-1], "labels": data[:, 1:]}
