"""FTSF-backed training-data pipeline (compatibility shim).

This is the paper's headline use case (its §V.A discussion): datasets live
as FTSF chunk rows in a delta table; an SGD batch fetch is a slice read
that touches only the covering chunk files. The machinery now lives in
:class:`~repro_torch.data.stream.StreamLoader` — epoch-pinned leased snapshot,
shard-aware deterministic shuffle, windowed batch prefetch through the
shared executor, and one merged ``read_many`` fetch plan per batch.
:class:`FTSFLoader` keeps the original single-tensor token-batch API as a
thin wrapper over it:

* **per-host sharding**: host *h* of *H* owns sample rows ``h::H``;
* **prefetch**: ``prefetch_depth`` maps onto the stream loader's batch
  window (bounded in-flight memory, structural backpressure);
* **hedged reads**: an optional duplicate attempt for a slow batch fetch
  (object-store reads are idempotent, so racing duplicates is safe);
* **determinism**: batch order is a pure function of (seed, epoch), so an
  elastic restart at ``start_step`` replays exactly the remaining stream;
* **lifecycle**: context-manager support, and a dropped loader releases
  its snapshot lease via GC finalizer (mirroring ``TensorRef``) — a
  forgotten ``close()`` no longer pins the snapshot forever.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from ..core.store import DeltaTensorStore
from ..lake.io import ReadExecutor
from .stream import StreamLoader


def write_token_dataset(store: DeltaTensorStore, tokens: np.ndarray, *,
                        tensor_id: str = "train_tokens",
                        target_file_bytes: int = 1 << 20) -> str:
    """tokens: (n_samples, seq_len) int32 -> FTSF rows (one chunk per sample)."""
    assert tokens.ndim == 2
    return store.put(tokens.astype(np.int32), layout="ftsf", tensor_id=tensor_id,
                     chunk_dims=1, target_file_bytes=target_file_bytes)


class FTSFLoader:
    """Single-tensor token-batch loader: the original pipeline API, now a
    shim over :class:`~repro_torch.data.stream.StreamLoader`.

    Yields ``{"tokens", "labels", "step"}`` dicts where labels are the
    next-token shift of tokens (−1 fill on the last position) and ``step``
    is the global step (``start_step`` resumes there deterministically).
    """

    def __init__(self, store: DeltaTensorStore, tensor_id: str, *,
                 batch_size: int, host_index: int = 0, n_hosts: int = 1,
                 seed: int = 0, prefetch_depth: int = 2,
                 start_step: int = 0, hedge_after_s: Optional[float] = None,
                 io: Optional[ReadExecutor] = None):
        self.store = store
        self.tid = tensor_id
        self.batch = batch_size
        self.host = host_index
        self.n_hosts = n_hosts
        self.hedge_after_s = hedge_after_s
        self._stream = StreamLoader(
            store, tensor_id, batch_size=batch_size,
            host_index=host_index, n_hosts=n_hosts, seed=seed,
            window=max(1, prefetch_depth), hedge_after_s=hedge_after_s,
            io=io)
        self.io = self._stream.io
        self.seed = seed
        if start_step:
            self._stream.seek(*divmod(int(start_step),
                                      self._stream.steps_per_epoch))

    @property
    def owned(self) -> np.ndarray:
        """Sample rows this host owns (``host_index::n_hosts``)."""
        return self._stream.owned

    @property
    def step(self) -> int:
        """Global step of the next batch to yield."""
        epoch, s = self._stream.cursor
        return epoch * self._stream.steps_per_epoch + s

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for b in self._stream:
            tokens = b["data"]
            labels = np.concatenate([tokens[:, 1:],
                                     np.full((len(tokens), 1), -1, np.int32)],
                                    axis=1)
            yield {"tokens": tokens, "labels": labels, "step": b["step"]}

    def close(self) -> None:
        """Cancel prefetch and release the snapshot lease (idempotent)."""
        self._stream.close()

    @property
    def closed(self) -> bool:
        """Whether the snapshot lease has been released."""
        return self._stream.closed

    def __enter__(self) -> "FTSFLoader":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
