"""DeltaTable — append/scan over parq-lite files tracked by the delta log.

Data skipping: every ``add`` action carries per-column min/max stats from
``columnar.write_table``; ``scan(filters=...)`` prunes whole files whose
[min,max] envelope misses the predicate before any byte of data is fetched.
That file-pruning is the mechanism behind the paper's read-slice wins: a
slice of tensor rows touches only the files whose chunk_index range overlaps
the slice.

The read path is split in two phases: :meth:`plan_scan` resolves a snapshot
and prunes add-actions using only log metadata (no data bytes touched);
:meth:`scan` hands the surviving files to the shared :class:`ReadExecutor`,
which fetches them concurrently (with block caching and optional hedging)
while batches decode in plan order as their bytes arrive.
"""

from __future__ import annotations

import hashlib
import os
import threading
import uuid
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from . import columnar
from .compression import (CompressionSpec, DeltaBase, encode_frame,
                          parse_compression)
from .io import (ReadExecutor, content_cache_key, get_default_executor,
                 store_scope)
from .log import (CommitConflict, DeltaLog, Snapshot, catalog_index_version)
from .object_store import ObjectNotFoundError, ObjectStore

# filter := {column: (lo, hi)} inclusive range; None bound = open
Filters = Dict[str, Tuple[Optional[float], Optional[float]]]

# part files that append_split encodes ahead of its upload, per thread
AHEAD_PER_WORKER = 2


def chunk_hash(data: bytes) -> str:
    """Content address of a part file's *decoded* bytes (blake2b-160).

    Hashing pre-codec bytes makes the address independent of codec,
    level, and shuffle settings, so re-encodes of identical content still
    dedup. 160 bits keeps accidental collisions out of reach; the chunk
    index additionally pairs every hash with its raw size and verifies
    object existence on reuse (collision paranoia, see
    :mod:`repro_torch.core.cas`).
    """
    return hashlib.blake2b(data, digest_size=20).hexdigest()


@dataclass
class _EncodedPart:
    """One part file's bytes as :meth:`DeltaTable.append` uploads them:
    ``data`` framed under ``spec`` (or raw), with the hash and size of the
    pre-codec bytes."""

    data: bytes
    stats: Dict[str, Any]
    raw_len: int
    content_hash: Optional[str]
    spec: Optional[CompressionSpec]
    codec_id: str
    itemsize: int


def _encode_part(columns: Dict[str, Any], spec: Optional[CompressionSpec],
                 shuffle_itemsize: int, delta_base: Optional[DeltaBase], *,
                 hashed: bool) -> _EncodedPart:
    """Encode one part file (pure CPU work, safe on any thread)."""
    framed = spec is not None and spec.active
    # under a file-level codec the built-in per-block zlib must stay
    # off: shuffling/compressing already-compressed blocks only burns
    # CPU and hides the codec's real ratio
    data, stats = columnar.write_table(columns, compress_blocks=not framed)
    raw_len = len(data)
    content_hash = chunk_hash(data) if hashed else None
    codec_id = "none"
    if framed:
        data, codec_id = encode_frame(data, spec, itemsize=shuffle_itemsize,
                                      delta_base=delta_base)
    return _EncodedPart(data, stats, raw_len, content_hash,
                        spec if framed else None, codec_id,
                        int(shuffle_itemsize))


def physical_path(add: Dict[str, Any]) -> str:
    """Relative object path holding this add-action's bytes.

    Content-addressed dedup keeps the logical ``path`` unique per
    add-action (the delta log's file map is path-keyed — two live adds
    can never share a literal ``path``) while ``physPath`` points at the
    shared stored object. Adds without ``physPath`` store their own
    bytes.
    """
    return add.get("physPath") or add["path"]


# in-flight two-phase uploads, per (store scope, table path) -> {rel path:
# refcount}. A data file uploaded but not yet committed is referenced by NO
# snapshot, so vacuum would reclassify it as an orphan and delete it out
# from under the writer — the commit would then land referencing dead
# paths. Writers (WriteBatch, compact) register their uploads here; vacuum
# treats registered paths as live. In-process protection only: it shares
# the lease model's scope (cross-process writers need an out-of-band
# grace period, as in production Delta).
_inflight_lock = threading.Lock()
_inflight: Dict[Tuple[Any, str], Dict[str, int]] = {}

# paths a running (in-process) vacuum has committed to deleting, per the
# same key. Dedup's reuse check races vacuum's liveness scan: a writer may
# look up a chunk the instant before vacuum deletes it. Vacuum condemns its
# doomed paths here (under _inflight_lock, re-checking _inflight) before
# the first delete; UploadGuard.reserve refuses condemned paths, so the
# writer falls back to a fresh upload instead of referencing a dying object.
_condemned: Dict[Tuple[Any, str], Set[str]] = {}


class UploadGuard:
    """Registers two-phase upload paths until the owning writer closes.

    ``add`` BEFORE the object put (the path is chosen first), ``close``
    after the commit lands (paths now live in a snapshot) or the writer
    abandons (paths become vacuumable orphans). Idempotent close.
    """

    def __init__(self, key: Tuple[Any, str]):
        self._key = key
        self._paths: List[str] = []
        self._closed = False

    def add(self, path: str) -> None:
        """Register one relative ``path`` as in-flight (pre-upload)."""
        with _inflight_lock:
            bucket = _inflight.setdefault(self._key, {})
            bucket[path] = bucket.get(path, 0) + 1
        self._paths.append(path)

    def reserve(self, path: str) -> bool:
        """Atomically register ``path`` unless a running vacuum condemned it.

        The dedup reuse path pins an *existing* object through the commit
        window with this: False means the object is mid-deletion and the
        caller must upload fresh bytes instead of referencing it.
        """
        with _inflight_lock:
            if path in _condemned.get(self._key, ()):
                return False
            bucket = _inflight.setdefault(self._key, {})
            bucket[path] = bucket.get(path, 0) + 1
        self._paths.append(path)
        return True

    def close(self) -> None:
        """Deregister every path this guard added (idempotent)."""
        if self._closed:
            return
        self._closed = True
        with _inflight_lock:
            bucket = _inflight.get(self._key)
            if bucket is None:
                return
            for p in self._paths:
                n = bucket.get(p, 0) - 1
                if n > 0:
                    bucket[p] = n
                else:
                    bucket.pop(p, None)
            if not bucket:
                _inflight.pop(self._key, None)

    def __enter__(self) -> "UploadGuard":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def _inflight_paths(key: Tuple[Any, str]) -> set:
    with _inflight_lock:
        return set(_inflight.get(key, ()))


@dataclass
class CompactResult:
    """What one OPTIMIZE pass did. Falsy when it was a no-op."""

    files_compacted: int = 0            # input files rewritten away
    files_written: int = 0              # merged files added
    files_recompressed: int = 0         # inputs rewritten under a new codec
    files_skipped_shared: int = 0       # left alone: dedup'd/delta-stored
    bytes_rewritten: int = 0            # physical bytes of the new files
    version: Optional[int] = None       # committed version (None = no commit)
    removed_paths: List[str] = field(default_factory=list)
    lost_races: int = 0                 # fenced commits a writer beat

    def __bool__(self) -> bool:
        return self.files_compacted > 0


@dataclass
class VacuumResult:
    """What one vacuum pass deleted (or would delete, under dry_run)."""

    files_deleted: int = 0
    bytes_reclaimed: int = 0
    index_files_deleted: int = 0        # pruned _catalog/<v>.index.json files
    deleted_paths: List[str] = field(default_factory=list)
    retained_versions: List[int] = field(default_factory=list)
    dry_run: bool = False

    def __bool__(self) -> bool:
        return self.files_deleted > 0


def file_overlaps(add: Dict[str, Any], filters: Optional[Filters]) -> bool:
    """True unless the add-action's min/max stats prove no row can match."""
    if not filters:
        return True
    stats = add.get("stats", {}).get("column_stats", {})
    for col, (lo, hi) in filters.items():
        st = stats.get(col)
        if st is None:
            continue  # no stats -> cannot prune
        if lo is not None and st["max"] < lo:
            return False
        if hi is not None and st["min"] > hi:
            return False
    return True


def _row_mask(batch: Dict[str, Any], filters: Optional[Filters]) -> Optional[np.ndarray]:
    if not filters:
        return None
    mask = None
    for col, (lo, hi) in filters.items():
        if col not in batch:
            continue
        v = batch[col]
        if not isinstance(v, np.ndarray) or v.dtype.kind not in "iuf":
            continue
        m = np.ones(len(v), dtype=bool)
        if lo is not None:
            m &= v >= lo
        if hi is not None:
            m &= v <= hi
        mask = m if mask is None else (mask & m)
    return mask


def _apply_mask(batch: Dict[str, Any], mask: Optional[np.ndarray]) -> Dict[str, Any]:
    if mask is None or mask.all():
        return batch
    out = {}
    idx = np.flatnonzero(mask)
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype.kind != "O":
            out[k] = v[idx]
        else:
            out[k] = [v[i] for i in idx]
    return out


def filter_rows(batch: Dict[str, Any],
                filters: Optional[Filters]) -> Dict[str, Any]:
    """Row-wise filter application on one decoded column batch.

    The public face of the scan path's mask step, for consumers that fetch
    and decode blocks themselves (the catalog's ``read_many`` scheduler
    decodes each shared file ONCE, then applies each request's own filters
    to the same decoded batch). No filters (or an all-true mask) returns
    the batch unchanged, so sharing the dict across requests stays safe.
    """
    return _apply_mask(batch, _row_mask(batch, filters))


def _columns_itemsize(columns: Dict[str, Any]) -> int:
    """Best-effort shuffle itemsize for a decoded column dict.

    Prefers a per-row ``dtype`` string column (FTSF/CSF/BSGS chunk rows
    record the tensor dtype), then the widest-by-bytes fixed-dtype array
    column (COO values/indices), else 1 (shuffle becomes the identity).
    Only ever used when an add-action predates recorded itemsizes.
    """
    dt = columns.get("dtype")
    if dt is not None and len(dt):
        try:
            return np.dtype(str(dt[0])).itemsize
        except TypeError:
            pass
    best, best_bytes = 1, -1
    for v in columns.values():
        if isinstance(v, np.ndarray) and v.dtype.kind in "iuf" \
                and v.nbytes > best_bytes:
            best, best_bytes = v.dtype.itemsize, v.nbytes
    return best


def _output_compression(adds: List[Dict[str, Any]],
                        merged_columns: Dict[str, Any],
                        target) -> Tuple[Any, int]:
    """(spec, shuffle_itemsize) a compact rewrite should encode under.

    With a ``recompress`` target, that target wins. Otherwise the inputs'
    codec is preserved — the codec of the largest input file, so compact
    never silently decompresses a table (nor compresses a raw one). The
    itemsize comes from the inputs' recorded ``itemsize`` when present,
    else it is derived from the decoded rows (legacy-file migration).
    """
    spec = target
    if spec is None:
        biggest = max(adds, key=lambda a: int(a.get("size", 0)))
        codec_id = biggest.get("codecRequested",
                               biggest.get("codec", "none"))
        if codec_id == "none":
            return None, 1  # raw inputs stay raw (legacy byte layout)
        spec = parse_compression(codec_id)
    itemsize = max((int(a.get("itemsize", 0)) for a in adds), default=0)
    if itemsize < 1:
        itemsize = _columns_itemsize(merged_columns)
    return spec, itemsize


def approx_row_bytes(columns: Dict[str, Any], rows: int) -> float:
    """Estimated bytes per row of a column dict (payload bytes only).

    What :meth:`DeltaTable.append_split` sizes part files with: ndarray
    columns count their buffer, object columns count per-item bytes/array
    sizes (8 bytes for anything else, e.g. a dtype string).
    """
    total = 0
    for v in columns.values():
        if isinstance(v, np.ndarray) and v.dtype.kind != "O":
            total += v.nbytes
        else:
            for item in v:
                if isinstance(item, (bytes, bytearray)):
                    total += len(item)
                elif isinstance(item, np.ndarray):
                    total += item.nbytes
                else:
                    total += 8
    return total / max(rows, 1)


def slice_columns(columns: Dict[str, Any], lo: int, hi: int) -> Dict[str, Any]:
    """Row window ``[lo, hi)`` of a column dict (ndarray views, list copies)."""
    out = {}
    for k, v in columns.items():
        if isinstance(v, np.ndarray) and v.dtype.kind != "O":
            out[k] = v[lo:hi]
        else:
            out[k] = list(v[lo:hi])
    return out


def _merge_batches(batches: List[Dict[str, Any]]) -> Dict[str, Any]:
    if not batches:
        return {}
    out: Dict[str, Any] = {}
    for key in batches[0]:
        vals = [b[key] for b in batches if key in b]
        if vals and isinstance(vals[0], np.ndarray) and vals[0].dtype.kind != "O":
            out[key] = np.concatenate(vals)
        else:
            merged: List[Any] = []
            for v in vals:
                merged.extend(v)
            out[key] = merged
    return out


class DeltaTable:
    """Append/scan/maintain one delta-logged table of parq-lite files."""

    def __init__(self, store: ObjectStore, path: str,
                 io: Optional[ReadExecutor] = None):
        self.store = store
        self.path = path.rstrip("/")
        self.log = DeltaLog(store, self.path)
        self.io = io or get_default_executor()
        # content-addressed chunk index (duck-typed; see repro_torch.core.cas).
        # The tensor store assigns one per table when dedup is on; a bare
        # DeltaTable stays index-free and every append uploads its bytes.
        self.cas: Optional[Any] = None

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(cls, store: ObjectStore, path: str,
               metadata: Optional[Dict[str, Any]] = None,
               io: Optional[ReadExecutor] = None) -> "DeltaTable":
        """Open the table at ``path``, committing CREATE if it is new."""
        t = cls(store, path, io=io)
        if t.exists():
            return t
        t.log.commit([{"metaData": metadata or {}}], op="CREATE TABLE")
        return t

    def exists(self) -> bool:
        """Whether any version has ever been committed here."""
        return self.log.latest_version() >= 0

    def version(self) -> int:
        """Latest committed version (-1 for a nonexistent table)."""
        return self.log.latest_version()

    # -- write ----------------------------------------------------------------

    def guard_uploads(self) -> UploadGuard:
        """Guard for two-phase uploads: registered paths are treated as
        live by concurrent (in-process) :meth:`vacuum` until closed."""
        return UploadGuard((store_scope(self.store), self.path))

    def append(self, columns: Dict[str, Any], *, partition_values: Optional[Dict[str, str]] = None,
               commit: bool = True,
               guard: Optional[UploadGuard] = None,
               compression: Union[None, str, CompressionSpec] = None,
               shuffle_itemsize: int = 1,
               cas: Optional[Any] = None,
               dedup_seen: Optional[Set[str]] = None,
               delta_base: Optional[DeltaBase] = None) -> Dict[str, Any]:
        """Write one parq-lite file; optionally defer the commit.

        With ``commit=False`` the data file is uploaded but invisible; the
        returned add-action must be passed to :meth:`commit_adds` later.
        This two-phase path is what the distributed checkpointer uses:
        every host uploads its shard files, then a single coordinator commit
        makes the checkpoint atomic. Pass a :meth:`guard_uploads` guard so
        a concurrent vacuum cannot mistake the not-yet-committed file for
        an orphan (registered before the first byte is uploaded).

        ``compression`` (a spec like ``"zlib+shuffle"`` or
        ``"zlib:9+shuffle"``) frames the file under a chunk-blob codec;
        ``shuffle_itemsize`` is the stored dtype width the byte-shuffle
        filter groups on (1 disables shuffling). The add-action then
        records ``codec`` (what actually happened — incompressible
        payloads fall back to ``"none"``), ``rawSize`` (the
        pre-compression length; ``size`` stays the stored length vacuum
        and the wire account in), and ``itemsize`` so later recompression
        (:meth:`compact`) can re-shuffle without re-learning the dtype.
        ``compression=None`` writes the exact pre-compression byte layout.

        ``cas`` (a :class:`repro_torch.core.cas.ChunkIndex`-shaped object)
        enables content-addressed dedup: when the encoded file's decoded
        bytes hash to an already-stored chunk, the returned add-action
        references the existing object via ``physPath`` and **no bytes
        are uploaded**. ``dedup_seen`` (a shared per-writer set of content
        hashes) stops two files of ONE staged tensor from aliasing the
        same object — the read scheduler's per-request completion
        accounting assumes a tensor's files are distinct objects.
        ``delta_base`` stores this file as an XOR delta against an
        existing base object (recorded as ``deltaBase``/``deltaBaseHash``
        on the add-action; reads reconstruct transparently).
        """
        spec = parse_compression(compression)
        if delta_base is not None and (spec is None or not spec.active):
            # an uncompressed XOR residue is exactly as large as the raw
            # bytes — deltas only pay off under a codec, so default one
            spec = parse_compression("zlib")
        part = _encode_part(columns, spec, shuffle_itemsize, delta_base,
                            hashed=cas is not None or delta_base is not None)
        return self._place(part, partition_values=partition_values,
                           commit=commit, guard=guard, cas=cas,
                           dedup_seen=dedup_seen, delta_base=delta_base)

    def _place(self, part: _EncodedPart, *,
               partition_values: Optional[Dict[str, str]], commit: bool,
               guard: Optional[UploadGuard], cas: Optional[Any],
               dedup_seen: Optional[Set[str]],
               delta_base: Optional[DeltaBase]) -> Dict[str, Any]:
        """Upload (or dedup) one encoded part file; see :meth:`append`."""
        add = {"path": f"part-{uuid.uuid4().hex}.pql", "stats": part.stats,
               "partitionValues": partition_values or {}, "dataChange": True}
        content_hash = part.content_hash
        if content_hash is not None:
            add["contentHash"] = content_hash
        if cas is not None and content_hash is not None and \
                (dedup_seen is None or content_hash not in dedup_seen):
            reused = cas.reuse(self, content_hash, part.raw_len, guard=guard)
            if reused is not None:
                add.update(reused)
                if dedup_seen is not None:
                    dedup_seen.add(content_hash)
                if commit:
                    self.log.commit([{"add": add}], op="WRITE")
                return add
        data = part.data
        if part.spec is not None:
            if part.codec_id != "none":
                add["codec"] = part.codec_id
                add["rawSize"] = part.raw_len
                add["itemsize"] = part.itemsize
            # else: incompressible fallback — stored raw and UNFRAMED, the
            # file is byte-identical to an uncompressed write, so no
            # codec/rawSize is recorded (ratio stays exactly 1.0)
            if part.codec_id != part.spec.id:
                # what actually happened differs from what was asked (raw
                # fallback, or shuffle skipped for 1-byte dtypes): record
                # the request so recompress-to-this-spec stays idempotent
                add["codecRequested"] = part.spec.id
            if delta_base is not None:
                # mirrored from the frame header so vacuum's liveness scan
                # and the read planner see the base dependency without
                # fetching a single data byte
                add["deltaBase"] = delta_base.key
                if delta_base.content_hash:
                    add["deltaBaseHash"] = delta_base.content_hash
        add["size"] = len(data)
        if guard is not None:
            guard.add(add["path"])
        self.store.put(f"{self.path}/{add['path']}", data)
        if cas is not None and content_hash is not None:
            cas.record(add)
            if dedup_seen is not None:
                dedup_seen.add(content_hash)
        if commit:
            self.log.commit([{"add": add}], op="WRITE")
        return add

    def append_split(self, columns: Dict[str, Any], *,
                     target_bytes: int,
                     partition_values: Optional[Dict[str, str]] = None,
                     guard: Optional[UploadGuard] = None,
                     compression: Union[None, str, CompressionSpec] = None,
                     shuffle_itemsize: int = 1,
                     cas: Optional[Any] = None,
                     dedup_seen: Optional[Set[str]] = None,
                     ) -> List[Dict[str, Any]]:
        """Seal ``columns`` into ~``target_bytes`` part files (no commit).

        The partial-chunk sealing step shared by the tensor store's batch
        write path and the streaming ingest writer: rows are windowed into
        files of roughly ``target_bytes`` payload (estimated via
        :func:`approx_row_bytes`), each uploaded through :meth:`append`
        with ``commit=False`` — so every flag (``guard``, ``compression``,
        ``cas``/``dedup_seen`` content dedup) applies per sealed file.
        Returns the add-actions in row order; the caller commits them via
        :meth:`commit_adds`.
        """
        rows = len(next(iter(columns.values())))
        per_file = max(1, int(target_bytes //
                              max(approx_row_bytes(columns, rows), 1)))
        spec = parse_compression(compression)
        starts = range(0, rows, per_file)

        def encode(lo):
            return _encode_part(slice_columns(columns, lo,
                                              min(rows, lo + per_file)),
                                spec, shuffle_itemsize, None,
                                hashed=cas is not None)
        # the files encode on threads (zlib and blake2b release the GIL)
        # and upload in row order, one at a time, so content dedup and the
        # guard see them as a serial writer would. At most AHEAD_PER_WORKER
        # encodes per thread run or wait ahead of the upload, which bounds
        # the encoded parts held in host memory
        workers = max(1, min(len(starts), os.cpu_count() or 1))
        ahead = AHEAD_PER_WORKER * workers
        adds: List[Dict[str, Any]] = []
        with ThreadPoolExecutor(max_workers=workers) as pool:
            pending = deque(pool.submit(encode, lo) for lo in starts[:ahead])
            nxt = iter(starts[ahead:])
            while pending:
                part = pending.popleft().result()
                adds.append(self._place(part, partition_values=partition_values,
                                        commit=False, guard=guard, cas=cas,
                                        dedup_seen=dedup_seen, delta_base=None))
                del part
                lo = next(nxt, None)
                if lo is not None:
                    pending.append(pool.submit(encode, lo))
        return adds

    def commit_adds(self, adds: List[Dict[str, Any]], *, removes: Sequence[str] = (),
                    op: str = "WRITE",
                    expected_version: Optional[int] = None) -> int:
        """Commit staged adds/removes as one version.

        ``expected_version`` fences the commit against exactly that snapshot
        (raises :class:`~repro_torch.lake.log.CommitConflict` if a concurrent
        writer landed first) — the serializable-writer primitive that
        ``WriteBatch``'s commit-retry/rebase loop is built on. Without it,
        losers of the log race blindly rebase and retry, which is only safe
        for append-only action lists.
        """
        actions: List[Dict[str, Any]] = [{"add": a} for a in adds]
        actions += [{"remove": {"path": p}} for p in removes]
        return self.log.commit(actions, op=op, expected_version=expected_version)

    # -- read -----------------------------------------------------------------

    def plan_scan(self, *, filters: Optional[Filters] = None,
                  partition_filters: Optional[Dict[str, str]] = None,
                  version: Optional[int] = None) -> List[Dict[str, Any]]:
        """Phase 1 of a read: pruned add-actions, metadata only.

        Partition pruning and min/max data skipping run against the log
        snapshot; nothing is fetched. The returned actions (in deterministic
        path order) are what the fetch phase — or an external scheduler —
        turns into object gets.
        """
        snap = self.log.snapshot(version)
        plan = []
        for add in snap.add_actions():
            if partition_filters:
                pv = add.get("partitionValues", {})
                if any(pv.get(k) != v for k, v in partition_filters.items()):
                    continue
            if not file_overlaps(add, filters):
                continue
            plan.append(add)
        return plan

    def fetch_adds(self, adds: Sequence[Dict[str, Any]],
                   columns: Optional[Sequence[str]] = None, *,
                   filters: Optional[Filters] = None) -> Iterator[Dict[str, Any]]:
        """Phase 2 of a read: fetch an externally-built plan.

        ``adds`` is any list of this table's add-actions (from
        :meth:`plan_scan`, or an O(1) catalog lookup that avoided the full
        snapshot walk). Files are fetched concurrently through the shared
        executor; batches decode and yield in plan order, with ``filters``
        applied row-wise exactly as :meth:`scan` would.
        """
        keys = [f"{self.path}/{physical_path(add)}" for add in adds]
        names = [content_cache_key(add["contentHash"])
                 if add.get("contentHash") else None for add in adds]
        for data in self.io.fetch_ordered(self.store, keys,
                                          cache_names=names):
            batch = columnar.read_table(data, columns)
            yield _apply_mask(batch, _row_mask(batch, filters))

    def scan(self, columns: Optional[Sequence[str]] = None, *,
             filters: Optional[Filters] = None,
             partition_filters: Optional[Dict[str, str]] = None,
             version: Optional[int] = None,
             prune_only: bool = False) -> Iterator[Dict[str, Any]]:
        """Yield column batches (one per surviving data file).

        Phase 2 of a read: the planned files are fetched concurrently
        through the shared executor; batches decode and yield in plan order
        as their gets complete, so results are bit-for-bit identical to a
        serial scan while I/O time is the makespan of parallel fetches.
        """
        plan = self.plan_scan(filters=filters, partition_filters=partition_filters,
                              version=version)
        if prune_only:
            for add in plan:
                yield {"__path__": add["path"], "__size__": add["size"]}
            return
        yield from self.fetch_adds(plan, columns, filters=filters)

    def read_all(self, columns: Optional[Sequence[str]] = None, *,
                 filters: Optional[Filters] = None,
                 partition_filters: Optional[Dict[str, str]] = None,
                 version: Optional[int] = None) -> Dict[str, Any]:
        """Concatenate all surviving batches into one column dict."""
        return _merge_batches(list(self.scan(
            columns, filters=filters, partition_filters=partition_filters,
            version=version)))

    def files(self, version: Optional[int] = None) -> List[Dict[str, Any]]:
        """Live add-actions at ``version`` (latest if None)."""
        return self.log.snapshot(version).add_actions()

    def total_bytes(self, version: Optional[int] = None) -> int:
        """Sum of live files' *stored* sizes at ``version``."""
        return sum(a["size"] for a in self.files(version))

    def snapshot(self, version: Optional[int] = None) -> Snapshot:
        """The log's materialized state at ``version`` (latest if None)."""
        return self.log.snapshot(version)

    # -- maintenance -----------------------------------------------------------

    def compact(self, max_rows_per_file: int = 1 << 20, *,
                max_retries: int = 3,
                recompress: Union[None, str, CompressionSpec] = None,
                ) -> CompactResult:
        """Rewrite multi-file partition groups into one file each.

        Files are compacted **per partition group** so the rewritten
        add-actions keep their ``partitionValues`` — merging across
        partitions would silently break ``partition_filters`` pruning (and
        would fuse incompatible row schemas, e.g. tensor headers with chunk
        rows) after OPTIMIZE.

        Rewritten files keep their inputs' chunk-blob codec (the codec of
        the largest input file): compacting a compressed table must not
        silently inflate it back to raw bytes. ``recompress=`` (a spec
        like ``"zlib+shuffle"``) instead re-encodes under that codec and
        ALSO rewrites single-file groups whose codec differs — the
        migration path for tables written before compression existed (see
        ``repro.launch.gc --recompress``). Header partitions are left
        alone (tiny, latency-critical, deliberately stored raw).

        When nothing needs rewriting this is a **commit-free no-op**
        returning a falsy result — maintenance crons must not grow the log
        (and invalidate pinned version vectors) doing nothing.

        The commit is **fenced** at the snapshot compact planned against:
        a concurrent writer that lands first (e.g. deleting a tensor whose
        files are being merged — re-adding them would resurrect it) forces
        a re-plan from the fresh snapshot rather than a blind rebase. A
        pass that loses ``max_retries + 1`` races to writers gives up and
        returns a falsy result (``lost_races`` counts them): compaction is
        an optimisation that the next pass retries, and a maintenance loop
        racing busy writers must not fail for it. (The reference re-raises
        the :class:`CommitConflict`.) Its uploaded files are invisible
        orphans that :meth:`vacuum` reclaims.
        Compact never deletes bytes; the rewritten-away files stay in the
        object store for older snapshots until :meth:`vacuum`.

        Content-addressed adds are preserved, never exploded: files whose
        stored object is shared (dedup references via ``physPath``, or a
        physical path referenced by more than one live add), and
        delta-stored files (``deltaBase``), are skipped rather than
        rewritten — merging them into per-group copies would multiply the
        physical bytes dedup saved. ``bytes_rewritten`` in the result is
        the *physical* size of the new files (what compact actually
        uploaded), never the sum over referencing add-actions.
        """
        target = parse_compression(recompress)
        attempt = 0
        with self.guard_uploads() as guard:
            while True:
                snap = self.log.snapshot()
                refs = Counter(physical_path(a) for a in snap.add_actions())
                groups: Dict[Tuple[Tuple[str, str], ...], List[Dict[str, Any]]] = {}
                for add in snap.add_actions():
                    pv = add.get("partitionValues", {}) or {}
                    groups.setdefault(tuple(sorted(pv.items())), []).append(add)
                new_adds: List[Dict[str, Any]] = []
                removes: List[str] = []
                recompressed = 0
                skipped_shared = 0
                for pv_items, adds in groups.items():
                    rewritable = []
                    for a in adds:
                        if a.get("physPath") or a.get("deltaBase") \
                                or refs[physical_path(a)] > 1:
                            skipped_shared += 1
                            continue
                        rewritable.append(a)
                    mismatched = 0
                    if target is not None and \
                            dict(pv_items).get("kind") != "header":
                        mismatched = sum(
                            1 for a in rewritable
                            if a.get("codecRequested",
                                     a.get("codec", "none")) != target.id)
                    if len(rewritable) <= 1 and not mismatched:
                        continue  # one file, right codec: nothing to do
                    keys = [f"{self.path}/{a['path']}" for a in rewritable]
                    batches = [columnar.read_table(data)
                               for data in self.io.fetch_ordered(self.store, keys)]
                    merged = _merge_batches(batches)
                    spec, itemsize = _output_compression(rewritable, merged,
                                                         target)
                    removes.extend(a["path"] for a in rewritable)
                    recompressed += mismatched
                    new_adds.append(self.append(
                        merged, commit=False,
                        partition_values=dict(pv_items), guard=guard,
                        compression=spec, shuffle_itemsize=itemsize))
                if not new_adds:
                    return CompactResult(files_skipped_shared=skipped_shared,
                                         lost_races=attempt)
                try:
                    v = self.commit_adds(new_adds, removes=removes, op="OPTIMIZE",
                                         expected_version=snap.version)
                except CommitConflict:
                    attempt += 1
                    if attempt > max_retries:  # the next pass tries again
                        return CompactResult(files_skipped_shared=skipped_shared,
                                             lost_races=attempt)
                    continue  # somebody landed first: re-plan on their snapshot
                return CompactResult(lost_races=attempt,
                                     files_compacted=len(removes),
                                     files_written=len(new_adds),
                                     files_recompressed=recompressed,
                                     files_skipped_shared=skipped_shared,
                                     bytes_rewritten=sum(
                                         int(a.get("size", 0))
                                         for a in new_adds),
                                     version=v,
                                     removed_paths=removes)

    def retained_versions(self, *, horizon: Optional[int] = None,
                          extra_versions: Sequence[int] = ()) -> Set[int]:
        """The versions a vacuum under these arguments would keep.

        ``[horizon, latest]`` plus every in-range ``extra_versions`` entry
        (leased snapshots). Empty for a nonexistent table.
        """
        latest = self.log.latest_version()
        if latest < 0:
            return set()
        lo = latest if horizon is None else max(0, min(int(horizon), latest))
        retained = set(range(lo, latest + 1))
        retained.update(int(v) for v in extra_versions if 0 <= int(v) <= latest)
        return retained

    def vacuum(self, *, horizon: Optional[int] = None,
               extra_versions: Sequence[int] = (),
               dry_run: bool = False,
               extra_live: Sequence[str] = ()) -> VacuumResult:
        """Delete data files referenced by no retained snapshot.

        ``horizon`` is the oldest version whose files must survive: every
        file live at any version in ``[horizon, latest]`` — plus any
        version in ``extra_versions`` (leased snapshots, whatever their
        age) — is kept, so time travel to retained versions keeps working.
        ``horizon=None`` keeps only the latest snapshot's files (the
        classic vacuum). Orphans from crashed two-phase writers are
        deleted (no snapshot references them) — but uploads a live
        in-process writer has registered via :meth:`guard_uploads` are
        treated as live: deleting them would corrupt the commit about to
        reference them.

        Liveness is **reference-counted at the physical level**: an object
        survives while ANY retained add-action references it — through
        its own ``path``, through a dedup alias (``physPath``), or as the
        ``deltaBase`` a delta-stored file reconstructs from. Deleting a
        tensor therefore only reclaims the chunks nothing else shares.
        ``extra_live`` injects additional relative paths to keep (the
        sharded store passes cross-shard delta-base references here).

        Deleted paths are evicted from the shared executor's block cache —
        a vacuumed file must not keep serving from cache. Spilled catalog
        indexes (``_catalog/<v>.index.json``) for non-retained versions
        are pruned alongside their snapshots; other ``_``-prefixed
        metadata (including the ``_cas/`` chunk index) is never touched.
        With ``dry_run`` nothing is deleted; the result reports what
        would be.
        """
        retained = self.retained_versions(horizon=horizon,
                                          extra_versions=extra_versions)
        if not retained:
            return VacuumResult(dry_run=dry_run)
        prefix = f"{self.path}/"
        live: set = set(extra_live)
        for v in sorted(retained):
            for path, a in self.log.snapshot(v).files.items():
                live.add(a.get("physPath") or path)
                db = a.get("deltaBase")
                if db and db.startswith(prefix):
                    live.add(db[len(prefix):])
        ikey = (store_scope(self.store), self.path)
        live |= _inflight_paths(ikey)

        res = VacuumResult(retained_versions=sorted(retained), dry_run=dry_run)
        doomed: List[Tuple[str, Optional[str]]] = []
        for key in list(self.store.list(prefix)):
            rel = key[len(prefix):]
            if rel.startswith("_"):
                # metadata trees (_delta_log/, _catalog/, _cas/, manifests)
                # are never data files; indexes are pruned separately below
                iv = catalog_index_version(self.path, key)
                if iv is not None and iv not in retained:
                    doomed.append((key, None))
                    res.index_files_deleted += 1
                continue
            if rel not in live:
                doomed.append((key, rel))
                res.files_deleted += 1
                res.deleted_paths.append(rel)
        condemned: Set[str] = set()
        if not dry_run and doomed:
            # freeze the doomed set against concurrent dedup reuse: from
            # here a writer's reserve() of any of these paths fails (it
            # re-uploads instead); paths a writer registered in-flight
            # since the liveness scan above are spared below
            with _inflight_lock:
                inflight_now = set(_inflight.get(ikey, ()))
                condemned = {rel for _, rel in doomed
                             if rel is not None and rel not in inflight_now}
                _condemned.setdefault(ikey, set()).update(condemned)
        try:
            spared: Set[str] = set()
            if not dry_run and condemned:
                # close the commit/vacuum race: a writer that uploaded
                # before the physical listing may have committed — and
                # closed its guard — after the snapshot replay above but
                # before the condemn check. A guard closed by that check
                # means its commit already landed, so re-listing the log
                # here surfaces every such version; anything it references
                # is live, not an orphan.
                latest_now = self.log.refresh_latest()
                for v in range(max(retained) + 1, latest_now + 1):
                    for path, a in self.log.snapshot(v).files.items():
                        live.add(a.get("physPath") or path)
                        db = a.get("deltaBase")
                        if db and db.startswith(prefix):
                            live.add(db[len(prefix):])
                fresh = {rel for rel in condemned if rel in live}
                if fresh:
                    condemned -= fresh
                    with _inflight_lock:
                        s = _condemned.get(ikey)
                        if s is not None:
                            s -= fresh
            for key, rel in doomed:
                if not dry_run and rel is not None and rel not in condemned:
                    spared.add(rel)
                    continue  # re-referenced mid-plan: now live
                try:
                    res.bytes_reclaimed += self.store.head(key)
                except ObjectNotFoundError:
                    continue  # raced another vacuum
                if not dry_run:
                    self.store.delete(key)
            if spared:
                res.files_deleted -= len(spared)
                res.deleted_paths = [p for p in res.deleted_paths
                                     if p not in spared]
        finally:
            if condemned:
                with _inflight_lock:
                    s = _condemned.get(ikey)
                    if s is not None:
                        s -= condemned
                        if not s:
                            _condemned.pop(ikey, None)
        if not dry_run and doomed:
            self.io.invalidate(self.store, [k for k, _ in doomed])
        return res
