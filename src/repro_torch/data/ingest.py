"""IngestWriter — streaming appends with watermark commits.

The paper's write path is batch ``put``: one tensor, one commit. The
north-star production store must also absorb *ever-growing datasets* while
training reads stream concurrently (the ingest half of Deep Lake's core
claim; the loader half is :class:`~repro_torch.data.stream.StreamLoader`).
:class:`IngestWriter` is that write path:

* **micro-batching**: ``append_rows(rows)`` buffers sample rows in memory;
  nothing is uploaded until a **watermark** trips — ``watermark_rows``
  buffered rows, or ``watermark_s`` seconds since the buffer's first row
  (checked on every append; call :meth:`poll` from an idle producer loop
  to honor the time watermark without new data). ``flush()`` forces it;
* **sealing**: a flush seals the buffer into framed FTSF chunk rows —
  row ``i`` of the buffer becomes chunk ``row_count + i`` of the tensor —
  split into ~``target_file_bytes`` part files through the existing
  two-phase :meth:`~repro_torch.lake.table.DeltaTable.append_split` upload path
  (upload guard registered, chunk-index dedup applied, store codec
  honored), plus a rewritten one-row header with the grown shape;
* **watermark commit**: the sealed files land as ONE fenced
  ``commit_adds`` (adds = chunks + new header, removes = old header) at
  ``op="INGEST"``. On :class:`~repro_torch.lake.log.CommitConflict` the writer
  rebases like :class:`~repro_torch.core.batch.WriteBatch`: a fence moved by an
  unrelated writer re-commits the same files against the new version; a
  concurrent change to *this* tensor (another ingest writer, an
  overwrite, a compact of its chunk files) abandons the staged uploads as
  vacuumable orphans, re-reads the committed row count, and re-seals the
  buffer at the new base indices — bounded by ``commit_retries``;
* **crash consistency**: the commit is the only visible transition. A
  writer killed between upload and commit leaves invisible orphans that
  ``vacuum`` reclaims — never a torn version. A commit whose
  acknowledgement is lost (the put landed, the response didn't) is
  detected by re-reading the snapshot before declaring failure, so those
  rows are not double-ingested. A restarted writer re-reads the committed
  row count and resumes exactly after the last durable row;
* **readers never blocked**: an epoch-pinned
  :class:`~repro_torch.data.stream.StreamLoader` keeps reading its frozen
  leased snapshot while ingest commits land;
  :meth:`~repro_torch.data.stream.StreamLoader.reopen` hands off to a fresh
  loader pinned at the latest version to pick up the new rows.

One writer instance is single-threaded by design (one buffer, one fence);
run concurrent writers as separate instances — their commits serialize
through the fenced retry loop, and writers on different shards never
conflict at all.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.batch import DEFAULT_COMMIT_RETRIES, _tensor_paths
from ..core.encodings.base import (dtype_name, first_scalar, header_dtype,
                                   header_shape, make_header)
from ..core.store import TARGET_FILE_BYTES, DeltaTensorStore
from ..lake.compression import CompressionSpec, parse_compression
from ..lake.log import CommitConflict, Snapshot


class IngestWriter:
    """Micro-batching appender onto one FTSF tensor (see module docstring).

    Built via :meth:`DeltaTensorStore.ingest`. The target tensor must be
    row-chunked FTSF (``chunk_dims == ndim - 1`` — what ``put`` writes by
    default), or not exist yet: a missing tensor is created on the first
    flush, its row shape and dtype inferred from the first appended rows.
    """

    def __init__(self, store: DeltaTensorStore, tensor_id: str, *,
                 watermark_rows: int = 64,
                 watermark_s: Optional[float] = None,
                 target_file_bytes: Optional[int] = None,
                 compression: Union[None, str, CompressionSpec] = None,
                 commit_retries: Optional[int] = None,
                 clock=None):
        if watermark_rows < 1:
            raise ValueError("watermark_rows must be >= 1")
        self.store = store
        self.tid = tensor_id
        self.shard = store.shard_of(tensor_id)
        self.table = store.tables[self.shard]
        self.watermark_rows = int(watermark_rows)
        self.watermark_s = watermark_s
        self.target = (TARGET_FILE_BYTES if target_file_bytes is None
                       else int(target_file_bytes))
        spec = parse_compression(compression)
        self.spec = spec if spec is not None else store.compression
        self.commit_retries = (DEFAULT_COMMIT_RETRIES if commit_retries is None
                               else max(0, int(commit_retries)))
        self.clock = clock or time.monotonic

        self._row_shape: Optional[Tuple[int, ...]] = None
        self._dtype: Optional[np.dtype] = None
        self._buffer: List[np.ndarray] = []
        self._buffered = 0
        self._first_ts: Optional[float] = None
        self._closed = False

        self.rows_buffered = 0      # rows ever handed to append_rows
        self.rows_committed = 0     # rows durably landed by this writer
        self.flushes = 0            # successful watermark commits
        self.conflicts = 0          # CommitConflicts hit (all retried)
        self.reencodes = 0          # conflict rebases that re-sealed

        self._pin(self.table.snapshot())

    # -- base snapshot ---------------------------------------------------------

    def _pin(self, snap: Snapshot) -> None:
        """Adopt ``snap`` as the commit fence: read the tensor's committed
        row count and live file set (what conflict rebase re-validates)."""
        self._base_version = snap.version
        self._tid_paths = sorted(_tensor_paths(snap).get(self.tid, []))
        header_add = None
        for add in snap.add_actions():
            pv = add.get("partitionValues") or {}
            if pv.get("tensor") == self.tid and pv.get("kind") == "header":
                header_add = add
                break
        if header_add is None:
            if self._tid_paths:
                raise ValueError(
                    f"tensor {self.tid!r} has chunk files but no header")
            self._row_count = 0
            self._header_path: Optional[str] = None
            return
        pv = header_add.get("partitionValues") or {}
        if pv.get("layout") != "ftsf":
            raise ValueError(
                f"ingest requires an ftsf tensor; {self.tid!r} is "
                f"{pv.get('layout')!r}")
        cols = self.store._header_for_path(header_add["path"], self.shard)
        shape = header_shape(cols)
        dtype = np.dtype(header_dtype(cols))
        chunk_dims = int(first_scalar(cols["chunk_dim_count"])) \
            if "chunk_dim_count" in cols else len(shape) - 1
        if chunk_dims != len(shape) - 1:
            raise ValueError(
                f"ingest requires row-chunked tensors (chunk_dims == ndim-1);"
                f" {self.tid!r} has chunk_dims={chunk_dims} at rank "
                f"{len(shape)}")
        row_shape = tuple(int(d) for d in shape[1:])
        if self._row_shape is not None and \
                (row_shape != self._row_shape or dtype != self._dtype):
            raise ValueError(
                f"tensor {self.tid!r} rows are {row_shape}:{dtype}, writer "
                f"buffered {self._row_shape}:{self._dtype}")
        self._row_shape, self._dtype = row_shape, dtype
        self._row_count = int(shape[0])
        self._header_path = header_add["path"]

    @property
    def row_count(self) -> int:
        """Rows durably committed for this tensor (the resume point: a
        restarted producer continues from here — rows that were only
        buffered when a writer died were never made visible)."""
        return self._row_count

    @property
    def rows_pending(self) -> int:
        """Rows buffered but not yet committed."""
        return self._buffered

    @property
    def version(self) -> int:
        """The shard version of the last commit this writer observed."""
        return self._base_version

    # -- buffering -------------------------------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("IngestWriter is closed")

    def _watermark_due(self) -> bool:
        if self._buffered >= self.watermark_rows:
            return True
        return (self.watermark_s is not None and self._first_ts is not None
                and self.clock() - self._first_ts >= self.watermark_s)

    def append_rows(self, rows: Any) -> Optional[int]:
        """Buffer ``rows`` (shape ``(k, *row_shape)``); commit on watermark.

        Returns the committed version when this append tripped a
        watermark flush, else None. The rows are copied into the buffer —
        the caller may reuse its array. Shape/dtype must match the
        tensor's rows exactly (inferred from the first append when the
        tensor does not exist yet).
        """
        self._check_open()
        rows = np.asarray(rows)
        if rows.ndim < 1:
            raise ValueError("append_rows wants (k, *row_shape), got a scalar")
        if len(rows) == 0:
            return None
        if self._row_shape is None:
            self._row_shape = tuple(int(d) for d in rows.shape[1:])
            self._dtype = rows.dtype
        elif tuple(rows.shape[1:]) != self._row_shape or \
                rows.dtype != self._dtype:
            raise ValueError(
                f"rows are {tuple(rows.shape[1:])}:{rows.dtype}, tensor "
                f"{self.tid!r} wants {self._row_shape}:{self._dtype}")
        self._buffer.append(np.array(rows, copy=True))
        self._buffered += len(rows)
        self.rows_buffered += len(rows)
        if self._first_ts is None:
            self._first_ts = self.clock()
        if self._watermark_due():
            return self.flush()
        return None

    def poll(self) -> Optional[int]:
        """Commit iff the time watermark has expired (idle-producer hook)."""
        self._check_open()
        if self._buffered and self._watermark_due():
            return self.flush()
        return None

    # -- sealing + committing --------------------------------------------------

    def _seal(self, rows: np.ndarray, guard) -> Tuple[List[Dict[str, Any]],
                                                      Tuple[str, Dict[str, Any]]]:
        """Upload the buffer as chunk rows ``row_count..row_count+k-1`` plus
        the grown header (two-phase: nothing visible until commit)."""
        base, k = self._row_count, int(len(rows))
        shape = (base + k,) + self._row_shape
        n = len(shape)
        flat = np.ascontiguousarray(rows).reshape(k, -1)
        cols: Dict[str, Any] = {
            "chunk_index": np.arange(base, base + k, dtype=np.int64),
            "chunk": [flat[i].tobytes() for i in range(k)],
            "dim_count": np.full(k, n, dtype=np.int32),
            "dimensions": [np.asarray(shape, dtype=np.int64)] * k,
            "chunk_dim_count": np.full(k, n - 1, dtype=np.int32),
            "dtype": [dtype_name(self._dtype)] * k,
        }
        adds = self.table.append_split(
            cols, target_bytes=self.target, guard=guard,
            compression=self.spec, shuffle_itemsize=self._dtype.itemsize,
            cas=self.table.cas, dedup_seen=set(),
            partition_values={"tensor": self.tid, "kind": "chunk",
                              "layout": "ftsf"})
        header = make_header(shape, self._dtype, chunk_dim_count=n - 1,
                             dimensions=np.asarray(shape, dtype=np.int64))
        h_add = self.table.append(
            header.columns, commit=False, guard=guard,
            partition_values={"tensor": self.tid, "kind": "header",
                              "layout": "ftsf"})
        return adds + [h_add], (h_add["path"], header.columns)

    def _landed_version(self, adds: List[Dict[str, Any]]) -> Optional[int]:
        """Did the staged commit actually land (lost-ack detection)?

        Part-file names are uuid-unique, so the staged paths appearing
        live in a fresh snapshot proves OUR commit succeeded even though
        the put's acknowledgement never arrived. Returns that snapshot's
        version, or None when the commit genuinely failed.
        """
        try:
            snap = self.table.snapshot()
        except Exception:
            return None
        staged = {a["path"] for a in adds}
        if staged and staged <= set(snap.files):
            return snap.version
        return None

    def flush(self) -> Optional[int]:
        """Seal + commit everything buffered; returns the version (None if
        the buffer was empty).

        On failure the buffer is KEPT — the rows were never made visible,
        and any uploaded part files are invisible orphans a later
        ``vacuum`` reclaims (the upload guard is closed on every exit).
        """
        self._check_open()
        if not self._buffered:
            return None
        rows = (self._buffer[0] if len(self._buffer) == 1
                else np.concatenate(self._buffer))
        k = int(len(rows))
        stats = self.store.commit_stats
        attempts = 0
        adds: Optional[List[Dict[str, Any]]] = None
        header_seed: Optional[Tuple[str, Dict[str, Any]]] = None
        guard = None
        try:
            while True:
                if adds is None:
                    guard = self.table.guard_uploads()
                    adds, header_seed = self._seal(rows, guard)
                removes = [self._header_path] if self._header_path else []
                try:
                    v = self.table.commit_adds(
                        adds, removes=removes, op="INGEST",
                        expected_version=self._base_version)
                except CommitConflict:
                    stats["conflicts"] += 1
                    self.conflicts += 1
                    attempts += 1
                    if attempts > self.commit_retries:
                        raise
                    stats["retries"] += 1
                    snap = self.table.snapshot()
                    live = sorted(_tensor_paths(snap).get(self.tid, []))
                    if live == self._tid_paths:
                        # fence moved for an unrelated reason (another
                        # tensor on this shard, maintenance elsewhere): the
                        # staged files still mean the same thing
                        self._base_version = snap.version
                        continue
                    # this tensor changed under us: abandon the staged
                    # uploads (vacuumable orphans) and re-seal on the new
                    # committed row count
                    guard.close()
                    guard, adds, header_seed = None, None, None
                    self._pin(snap)
                    self.reencodes += 1
                    continue
                except Exception:
                    landed = self._landed_version(adds)
                    if landed is None:
                        raise
                    # ambiguous commit: the put landed, its ack was lost.
                    # Failing here would re-ingest these rows on retry.
                    v = landed
                return self._committed(v, k, adds, header_seed)
        finally:
            if guard is not None:
                guard.close()

    def _committed(self, v: int, k: int, adds: List[Dict[str, Any]],
                   header_seed: Tuple[str, Dict[str, Any]]) -> int:
        self.store.commit_stats["commits"] += 1
        self._tid_paths = sorted(
            (set(self._tid_paths) - {self._header_path})
            | {a["path"] for a in adds})
        self._header_path = header_seed[0]
        self._row_count += k
        self._base_version = v
        # the new header is visible now and its path is immutable: safe to
        # seed the store's by-path cache (mirrors WriteBatch post-commit)
        self.store._seed_header(*header_seed)
        self.store._maybe_spill(self.shard, v, adds_hint=len(adds))
        self._buffer.clear()
        self._buffered = 0
        self._first_ts = None
        self.flushes += 1
        self.rows_committed += k
        return v

    # -- lifecycle -------------------------------------------------------------

    def close(self, *, flush: bool = True) -> Optional[int]:
        """Final flush (unless ``flush=False``), then refuse further use.

        Returns the final committed version (None when nothing was
        pending). ``flush=False`` abandons buffered rows — they were never
        visible, so nothing needs cleaning up.
        """
        if self._closed:
            return None
        v = self.flush() if flush and self._buffered else None
        self._closed = True
        self._buffer.clear()
        self._buffered = 0
        return v

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "IngestWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # an exception abandons the buffer (mirroring WriteBatch): the
        # producer decides whether to re-append after recovery
        self.close(flush=exc_type is None)

    def stats(self) -> Dict[str, Any]:
        """Writer-side counters (commit_stats on the store aggregates
        across writers)."""
        return {"rows_buffered": self.rows_buffered,
                "rows_committed": self.rows_committed,
                "rows_pending": self._buffered,
                "row_count": self._row_count,
                "flushes": self.flushes,
                "conflicts": self.conflicts,
                "reencodes": self.reencodes,
                "watermark_rows": self.watermark_rows,
                "watermark_s": self.watermark_s}
