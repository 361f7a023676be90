"""Streaming training-speed data loader over the Delta Tensor store.

The paper optimizes one-shot tensor reads; the north-star workload is
*feeding a training loop at hardware speed* (Deep Lake's central claim: a
lakehouse can stream batches as fast as local disk). :class:`StreamLoader`
is that read path:

* **epoch pinning**: the loader leases one catalog snapshot (version
  vector) for its lifetime — a concurrent writer appending to the dataset
  tables changes nothing this loader reads, and vacuum cannot delete its
  files. Re-create the loader (or open a new one per epoch) to pick up
  freshly ingested data;
* **shard-aware shuffled sampling**: samples are the union of rows across
  one or more tensors (all sharing trailing shape + dtype); each epoch's
  order is a seeded deterministic shuffle that *interleaves* shard groups
  proportionally, so every batch spreads its reads across the store's
  shard tables instead of hammering one table's files at a time;
* **windowed prefetch**: up to ``window`` whole batches are in flight as
  jobs on the shared :class:`~repro_torch.lake.io.ReadExecutor` work pool.
  Submission happens only as the consumer drains, so a stalled training
  step applies backpressure structurally and peak prefetch memory is
  bounded by ``window × batch_bytes`` (tracked in
  ``peak_inflight_bytes``);
* **merged batch fetch**: each batch's rows coalesce into per-tensor
  contiguous runs and fetch through ONE
  :meth:`~repro_torch.core.catalog.Catalog.read_many` plan — shared chunk files
  dedup to a single get, decode overlaps in-flight fetches;
* **resumability**: the epoch plan is a pure function of ``(seed,
  epoch)``, so a ``(epoch, step)`` cursor restarts the stream mid-epoch
  bit-for-bit (elastic training restarts);
* **device batches**: with ``device=`` each batch is reordered into one
  host staging buffer (pinned for a CUDA device) and crosses to the device
  in one copy, counted in ``bytes_to_device``.

:class:`~repro_torch.data.pipeline.FTSFLoader` is now a thin compatibility shim
over this class. This is the port of ``repro.data.stream``: batches are
numpy arrays, or torch tensors on the device named.
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from .. import obs
from ..core.encodings.base import header_dtype, header_shape
from ..core.store import DeltaTensorStore, VersionArg
from ..lake.device import resolve_device, torch_dtype
from ..lake.io import LatencyHistogram, ReadExecutor

Cursor = Tuple[int, int]  # (epoch, step within epoch)


class StreamLoader:
    """Epoch-pinned shuffled streaming reader (see module docstring).

    ``tensors`` is one tensor id or a list of them; every tensor's leading
    dimension indexes samples and all must share trailing shape and dtype
    (they may live in different store shards — that is the point: the
    shuffle interleaves them). Host ``host_index`` of ``n_hosts`` owns the
    sample subset ``h::H`` of the global id space.

    ``window`` bounds in-flight prefetched batches (and so prefetch
    memory: ``window × batch_size × row_nbytes``). ``device=False`` (the
    default) yields numpy batches; ``device=True`` yields torch tensors on
    the store's device (``"cuda"`` unless the store was built for another),
    and ``device="cuda"`` / ``"cpu"`` / a :class:`torch.device` names one.
    A device batch is one transfer off the reorder staging buffer (pinned
    for CUDA). A CUDA device on a host without one raises here, with no
    fallback to the CPU. ``epochs=None``
    streams forever. ``clock`` (default ``time.perf_counter``) timestamps
    per-batch fetch latency — benchmarks pass the virtual clock of a
    modeled store. ``close()`` releases the snapshot lease; the loader is
    a context manager and a dropped loader is finalized by GC (mirroring
    :class:`~repro_torch.core.catalog.TensorRef`).
    """

    def __init__(self, store: DeltaTensorStore,
                 tensors: Union[str, Sequence[str]], *,
                 batch_size: int, host_index: int = 0, n_hosts: int = 1,
                 seed: int = 0, window: int = 4,
                 epochs: Optional[int] = None,
                 start_cursor: Cursor = (0, 0),
                 version: VersionArg = None,
                 hedge_after_s: Optional[float] = None,
                 io: Optional[ReadExecutor] = None,
                 read_window: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 device: Any = False):
        self.store = store
        # None: numpy batches; else the torch device batches land on
        self.device: Optional[torch.device] = (
            None if device is False or device is None
            else resolve_device(store.device if device is True else device))
        self.tensor_ids: List[str] = (
            [tensors] if isinstance(tensors, str) else list(tensors))
        if not self.tensor_ids:
            raise ValueError("StreamLoader needs at least one tensor")
        self.batch = int(batch_size)
        self.host_index = int(host_index)
        self.n_hosts = int(n_hosts)
        self.seed = int(seed)
        self.window = max(1, int(window))
        self.epochs = epochs
        self.hedge_after_s = hedge_after_s
        self.read_window = read_window
        self.io = io or store.io
        self.clock = clock or time.perf_counter

        # pin the dataset generation: every batch this loader ever yields
        # comes from this one catalog snapshot, lease-protected from vacuum
        self.catalog = store.catalog(version)
        self._lease = store.leases.acquire(self.catalog.version_vector)
        self._finalizer = weakref.finalize(self, self._lease.release)

        # sample space: union of rows across tensors, global ids in tensor
        # order; headers are warmed here so batch fetches start plan-ready
        offsets = [0]
        shard_of: List[int] = []
        row_shape: Optional[Tuple[int, ...]] = None
        dtype: Optional[np.dtype] = None
        for tid in self.tensor_ids:
            header = self.catalog.header(tid)
            shape = header_shape(header)
            dt = np.dtype(header_dtype(header))
            if row_shape is None:
                row_shape, dtype = shape[1:], dt
            elif shape[1:] != row_shape or dt != dtype:
                raise ValueError(
                    f"tensor {tid!r} rows {shape[1:]}:{dt} incompatible "
                    f"with {row_shape}:{dtype}")
            shard_of.append(self.catalog.entry(tid).shard)
            offsets.append(offsets[-1] + shape[0])
        assert row_shape is not None and dtype is not None
        self.row_shape = tuple(int(d) for d in row_shape)
        self.dtype = dtype
        self.row_nbytes = int(np.prod(self.row_shape,
                                      dtype=np.int64)) * dtype.itemsize
        self.batch_bytes = self.batch * self.row_nbytes
        self._offsets = np.asarray(offsets, dtype=np.int64)

        self.owned = np.arange(int(self._offsets[-1]),
                               dtype=np.int64)[self.host_index::self.n_hosts]
        if len(self.owned) < self.batch:
            raise ValueError("fewer owned samples than batch size")
        self.steps_per_epoch = len(self.owned) // self.batch
        tensor_idx = np.searchsorted(self._offsets, self.owned,
                                     side="right") - 1
        self._owned_shard = np.asarray([shard_of[t] for t in tensor_idx],
                                       dtype=np.int64)

        self._cursor: Cursor = (int(start_cursor[0]), int(start_cursor[1]))
        self._head: Cursor = self._cursor  # next batch to *submit*
        self._pending: "OrderedDict[Cursor, Tuple[Any, float, np.ndarray]]" = \
            OrderedDict()
        self._plan_cache: Tuple[Optional[int], Optional[np.ndarray]] = (None, None)
        self.batch_latency = LatencyHistogram()
        self.batches_yielded = 0
        self.inflight_bytes = 0
        self.peak_inflight_bytes = 0

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        """Cancel prefetch and release the snapshot lease (idempotent)."""
        for fut, _, _ in self._pending.values():
            fut.cancel()
        self._pending.clear()
        self.inflight_bytes = 0
        self._finalizer()

    @property
    def closed(self) -> bool:
        """Whether the snapshot lease has been released."""
        return not self._finalizer.alive

    def reopen(self, *, version: VersionArg = None,
               start_cursor: Cursor = (0, 0)) -> "StreamLoader":
        """Hand off to a fresh loader pinned at ``version`` (latest if None).

        The streaming-ingest handoff: this loader's snapshot is frozen by
        design — rows an :class:`~repro_torch.data.ingest.IngestWriter` commits
        after the pin are invisible to it. Between epochs, call
        ``loader = loader.reopen()`` to re-pin at the store's current
        latest: the new loader has identical configuration (batch size,
        host split, seed, window, ...), sees every row committed since,
        and restarts its epoch/step counters at ``start_cursor``. This
        loader is closed (its lease released) once the new one holds its
        own lease, so there is no window where vacuum could reclaim either
        generation's files.
        """
        new = StreamLoader(
            self.store, list(self.tensor_ids), batch_size=self.batch,
            host_index=self.host_index, n_hosts=self.n_hosts,
            seed=self.seed, window=self.window, epochs=self.epochs,
            start_cursor=start_cursor, version=version,
            hedge_after_s=self.hedge_after_s, io=self.io,
            read_window=self.read_window,
            clock=None if self.clock is time.perf_counter else self.clock,
            device=False if self.device is None else self.device)
        self.close()
        return new

    def __enter__(self) -> "StreamLoader":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- deterministic epoch plan ----------------------------------------------

    def _epoch_plan(self, epoch: int) -> np.ndarray:
        """This epoch's full sample order: a pure function of (seed, epoch).

        Owned samples are partitioned by the store shard their tensor
        lives in, shuffled *within* each shard group, then interleaved
        proportionally across groups: the k-th sample of a c-long group
        sorts at key (k+1)/c, so any batch-sized window of the plan
        touches every shard in proportion to its share of the data — no
        shard table becomes the batch's hot spot.
        """
        cached_epoch, cached = self._plan_cache
        if cached_epoch == epoch:
            return cached  # type: ignore[return-value]
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + epoch) & 0x7FFFFFFF)
        n = len(self.owned)
        key = np.empty(n, np.float64)
        tie = np.empty(n, np.int64)
        for s in np.unique(self._owned_shard):
            grp = np.flatnonzero(self._owned_shard == s)
            perm = grp[rng.permutation(len(grp))]
            key[perm] = (np.arange(len(grp), dtype=np.float64) + 1.0) / len(grp)
            tie[perm] = s
        plan = self.owned[np.lexsort((tie, key))]
        self._plan_cache = (epoch, plan)
        return plan

    def _rows_for(self, epoch: int, step: int) -> np.ndarray:
        if not 0 <= step < self.steps_per_epoch:
            raise IndexError(f"step {step} outside epoch "
                             f"(steps_per_epoch={self.steps_per_epoch})")
        plan = self._epoch_plan(epoch)
        return plan[step * self.batch:(step + 1) * self.batch]

    # -- batch fetch (runs in the executor's work pool) ------------------------

    def _fetch_batch(self, rows: np.ndarray) -> Tuple[Any, float]:
        """Assemble one batch: per-tensor runs -> one read_many plan."""
        tensor_idx = np.searchsorted(self._offsets, rows, side="right") - 1
        requests: List[Tuple[str, Optional[Sequence]]] = []
        placements: List[np.ndarray] = []
        for t in np.unique(tensor_idx):
            pos = np.flatnonzero(tensor_idx == t)
            local = rows[pos] - self._offsets[t]
            order = np.argsort(local, kind="stable")
            pos, local = pos[order], local[order]
            # coalesce consecutive rows into contiguous slice requests so
            # file pruning (and key dedup in the plan) sees ranges
            cuts = np.flatnonzero(np.diff(local) != 1) + 1
            starts = np.concatenate(([0], cuts))
            ends = np.concatenate((cuts, [len(local)]))
            for a, b in zip(starts, ends):
                lo, hi = int(local[a]), int(local[b - 1]) + 1
                requests.append((self.tensor_ids[int(t)], [(lo, hi)]))
                placements.append(pos[a:b])

        def fetch() -> List[np.ndarray]:
            return self.catalog.read_many(requests, window=self.read_window)

        if self.hedge_after_s is not None:
            arrays = self.io.hedged(fetch, hedge_after_s=self.hedge_after_s)
        else:
            arrays = fetch()
        if self.device is None:
            out = np.empty((len(rows),) + self.row_shape, self.dtype)
            for arr, pos in zip(arrays, placements):
                out[pos] = arr
            return out, self.clock()
        # one staging buffer (needed anyway for the shuffle reorder), pinned
        # for CUDA, and one transfer: the batch first exists ordered on the
        # device
        staging = torch.empty((len(rows), self.row_nbytes), dtype=torch.uint8,
                              pin_memory=self.device.type == "cuda")
        host = staging.numpy()
        for arr, pos in zip(arrays, placements):
            host[pos] = np.ascontiguousarray(arr).view(np.uint8).reshape(
                len(pos), self.row_nbytes)
        dev = staging.to(self.device, non_blocking=True)
        self.io.stats.bump(bytes_to_device=int(staging.numel()))
        data = dev.view(torch_dtype(self.dtype)).reshape(
            (len(rows),) + self.row_shape)
        return data, self.clock()

    # -- streaming -------------------------------------------------------------

    @property
    def cursor(self) -> Cursor:
        """``(epoch, step)`` of the next batch to yield — checkpoint this
        and pass it back as ``start_cursor`` to resume bit-for-bit."""
        return self._cursor

    def seek(self, epoch: int, step: int) -> None:
        """Reposition the stream (drops any prefetched batches)."""
        for fut, _, _ in self._pending.values():
            fut.cancel()
        self._pending.clear()
        self.inflight_bytes = 0
        self._cursor = self._head = (int(epoch), int(step))

    def _advance(self, cur: Cursor) -> Cursor:
        epoch, step = cur
        step += 1
        return (epoch + 1, 0) if step >= self.steps_per_epoch else (epoch, step)

    def _in_range(self, cur: Cursor) -> bool:
        return self.epochs is None or cur[0] < self.epochs

    def _submit(self, cur: Cursor) -> None:
        rows = self._rows_for(*cur)  # plan built on the consumer thread
        self._pending[cur] = (self.io.submit(self._fetch_batch, rows),
                              self.clock(), rows)
        self.inflight_bytes += self.batch_bytes
        if self.inflight_bytes > self.peak_inflight_bytes:
            self.peak_inflight_bytes = self.inflight_bytes

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        """Yield batches: ``{"data", "samples", "epoch", "step"}``.

        ``data`` is ``(batch_size, *row_shape)`` in plan order,
        ``samples`` the global sample ids it holds, ``step`` the global
        step (``epoch * steps_per_epoch + step_in_epoch``). Keeps at most
        ``window`` batches in flight; a slow consumer stalls submission,
        not the executor.
        """
        while not self.closed and self._in_range(self._cursor):
            # the consumer's request to the batch it gets (host time only)
            with obs.span("loader.next", device=False):
                while (len(self._pending) < self.window
                       and self._in_range(self._head)):
                    self._submit(self._head)
                    self._head = self._advance(self._head)
                cur = self._cursor
                fut, t_submit, rows = self._pending.pop(cur)
                data, t_done = fut.result()
                self.inflight_bytes -= self.batch_bytes
                # submit -> ready: the consumer-visible fetch latency of this
                # batch (virtual seconds when clock= is a modeled store's)
                self.batch_latency.observe(t_done - t_submit)
                self.batches_yielded += 1
                epoch, step = cur
                self._cursor = self._advance(cur)
            yield {"data": data,
                   "samples": rows,
                   "epoch": epoch,
                   "step": epoch * self.steps_per_epoch + step}

    # -- reporting -------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Loader-side counters + per-batch fetch-latency percentiles."""
        return {"batches_yielded": self.batches_yielded,
                "steps_per_epoch": self.steps_per_epoch,
                "window": self.window,
                "batch_bytes": self.batch_bytes,
                "inflight_bytes": self.inflight_bytes,
                "peak_inflight_bytes": self.peak_inflight_bytes,
                "memory_bound_bytes": self.window * self.batch_bytes,
                "batch_latency": self.batch_latency.summary()}
