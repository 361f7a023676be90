"""Snapshot-pinned tensor catalog + lazy TensorRef handles.

The eager ``DeltaTensorStore.get/get_slice`` paths used to re-walk the full
``table.files()`` list on every access: O(files) metadata work per read, and
two reads in one burst could observe different table versions. The
:class:`Catalog` fixes both: it is built **once per snapshot** by a single
pass over the add-actions and indexes tensor-id -> (layout, header
add-action, chunk add-actions), so every subsequent read is an O(1) dict
lookup against one immutable table version.

:class:`TensorRef` is the lazy handle the redesigned public API returns
(``store.open(tid)``): metadata properties (``shape``/``dtype``/``layout``/
``nbytes``) touch at most the 1-row header file, numpy-style
``__getitem__`` maps int/slice/Ellipsis onto the paper's read-slice
operation, and ``read_async`` fans the chunk fetches out on the shared
:class:`~repro_torch.lake.io.ReadExecutor` work pool. Refs opened from one
catalog are snapshot-consistent with each other by construction — the Deep
Lake / NeurStore "view over a pinned commit" model.

On a **sharded** store the catalog is the merged cross-shard index: it is
built from one snapshot per shard table and pinned to the resulting
*version vector* (``catalog.version == (v0, v1, ...)``). Each entry
remembers its shard, so refs route fetches to the right shard table while
consumers see one flat tensor namespace. One logical snapshot = one tuple
of shard versions; there is no single total order across shards.

**Spilled indexes** (the NeurStore move: keep the index beside the data):
past a file-count threshold the store writes the per-tensor grouping of a
committed shard snapshot to ``<table>/_catalog/<version>.index.json``. A
catalog built for a spilled version is then ONE object get + a dict load
(:class:`ShardSource` with ``index`` set) instead of a full snapshot walk
(log replay + O(files) classification); absent indexes fall back to the
walk transparently. :func:`build_catalog_index` defines the format.

**Leases**: every :class:`TensorRef` acquires a
:class:`~repro_torch.core.leases.Lease` on its catalog's version vector at
construction and releases it on ``close()`` / context-manager exit / GC,
so ``store.vacuum()`` never deletes files a live ref still needs.
"""

from __future__ import annotations

import weakref
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Any, Dict, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np

from ..lake import columnar
from ..lake.io import ReadExecutor, content_cache_key
from ..lake.log import Snapshot
from ..lake.table import Filters, file_overlaps, filter_rows, physical_path
from .encodings.base import (SparseCOO, get_codec, header_dtype,
                             header_shape, normalize_slices)

if TYPE_CHECKING:  # pragma: no cover - import cycle is typing-only
    from .store import DeltaTensorStore

CATALOG_INDEX_FORMAT = 1


def build_catalog_index(snapshot: Snapshot) -> Dict[str, Any]:
    """The spilled form of one shard snapshot's tensor grouping.

    Deterministic for a given snapshot (add-actions walk in sorted path
    order), so re-spilling a version is idempotent and an index-built
    catalog is bit-for-bit identical to a walk-built one.
    """
    tensors: Dict[str, Dict[str, Any]] = {}
    for add in snapshot.add_actions():
        pv = add.get("partitionValues") or {}
        tid = pv.get("tensor")
        if tid is None:
            continue  # non-tensor rows (e.g. checkpoint manifests)
        rec = tensors.setdefault(
            tid, {"layout": pv.get("layout", "?"), "header": [], "chunks": []})
        key = "header" if pv.get("kind") == "header" else "chunks"
        rec[key].append(add)
    return {"format": CATALOG_INDEX_FORMAT, "version": snapshot.version,
            "files": len(snapshot.files), "tensors": tensors}


@dataclass(frozen=True)
class ShardSource:
    """One shard's contribution to a catalog: a walked snapshot OR a
    loaded spilled index (exactly one of the two is set)."""

    version: int
    snapshot: Optional[Snapshot] = None
    index: Optional[Dict[str, Any]] = None


@dataclass
class TensorEntry:
    """One tensor's add-actions inside a single (shard) snapshot."""

    tensor_id: str
    layout: str
    shard: int = 0
    header_adds: List[Dict[str, Any]] = field(default_factory=list)
    chunk_adds: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def nbytes(self) -> int:
        """Stored bytes across this tensor's files (compressed size for
        frame-compressed files — what the object store actually holds)."""
        return (sum(a["size"] for a in self.header_adds) +
                sum(a["size"] for a in self.chunk_adds))

    @property
    def paths(self) -> List[str]:
        """Relative file paths of every header + chunk add-action."""
        return [a["path"] for a in self.header_adds + self.chunk_adds]


class Catalog:
    """Immutable tensor index over one logical snapshot (1+ shard snapshots).

    Built in one O(files) pass per shard; every lookup afterwards is O(1).
    The store caches catalogs per version vector (snapshots never change),
    so a read burst pays the walk once, not once per read. On a sharded
    store the per-shard indexes merge into one flat namespace — the stable
    router guarantees a tensor lives in exactly one shard, so the merge is
    collision-free by construction.
    """

    def __init__(self, store: "DeltaTensorStore",
                 sources: Union[Snapshot, ShardSource,
                                Sequence[Union[Snapshot, ShardSource]]]):
        self._store = store
        if isinstance(sources, (Snapshot, ShardSource)):
            sources = [sources]
        self._sources: Tuple[ShardSource, ...] = tuple(
            s if isinstance(s, ShardSource)
            else ShardSource(version=s.version, snapshot=s)
            for s in sources)
        self._versions: Tuple[int, ...] = tuple(s.version for s in self._sources)
        self._entries: Dict[str, TensorEntry] = {}
        self._headers: Dict[str, Dict[str, Any]] = {}  # tid -> parsed header
        for shard, source in enumerate(self._sources):
            if source.index is not None:
                # spilled path: the grouping work was done at write time
                for tid, rec in source.index["tensors"].items():
                    self._entries[tid] = TensorEntry(
                        tensor_id=tid, layout=rec["layout"], shard=shard,
                        header_adds=list(rec["header"]),
                        chunk_adds=list(rec["chunks"]))
                continue
            for add in source.snapshot.add_actions():
                pv = add.get("partitionValues", {}) or {}
                tid = pv.get("tensor")
                if tid is None:
                    continue  # non-tensor rows (e.g. checkpoint manifests)
                entry = self._entries.get(tid)
                if entry is None:
                    entry = self._entries[tid] = TensorEntry(
                        tensor_id=tid, layout=pv.get("layout", "?"),
                        shard=shard)
                if pv.get("kind") == "header":
                    entry.header_adds.append(add)
                else:
                    entry.chunk_adds.append(add)

    # -- inventory -----------------------------------------------------------

    @property
    def version(self) -> Union[int, Tuple[int, ...]]:
        """Pinned version: an int on 1-shard stores (the pre-sharding API),
        a per-shard version vector tuple on sharded stores."""
        if len(self._versions) == 1:
            return self._versions[0]
        return self.version_vector

    @property
    def version_vector(self) -> Tuple[int, ...]:
        """Per-shard pinned versions (1-tuple on unsharded stores)."""
        return self._versions

    @property
    def n_shards(self) -> int:
        """How many shard snapshots this catalog merges (1 if unsharded)."""
        return len(self._versions)

    def table_for(self, shard: int):
        """The shard's :class:`~repro_torch.lake.table.DeltaTable`."""
        return self._store.tables[shard]

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, tid: str) -> bool:
        return tid in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def tensors(self) -> List[Tuple[str, str]]:
        """Sorted ``(tensor_id, layout)`` pairs — the old list_tensors."""
        return sorted((t, e.layout) for t, e in self._entries.items())

    def entry(self, tid: str) -> TensorEntry:
        """The tensor's add-action grouping; raises ``KeyError`` with the
        pinned version in the message when ``tid`` is absent."""
        try:
            return self._entries[tid]
        except KeyError:
            raise KeyError(f"tensor {tid!r} not found at v{self.version}") from None

    # -- header access ---------------------------------------------------------

    def header(self, tid: str) -> Dict[str, Any]:
        """Parsed 1-row header columns; fetched once per (snapshot, tensor).

        Header files are immutable and content-named, so the store-level
        by-path cache (seeded by committed writes) and the executor block
        cache both apply; a warm ref never touches the object store.
        """
        cols = self._headers.get(tid)
        if cols is not None:
            return cols
        entry = self.entry(tid)
        if not entry.header_adds:
            raise KeyError(f"tensor {tid!r}: no header at v{self.version}")
        add = entry.header_adds[0]
        cols = self._store._header_for_path(add["path"], shard=entry.shard)
        self._headers[tid] = cols
        return cols

    # -- handles ---------------------------------------------------------------

    def open(self, tid: str) -> "TensorRef":
        """A lazy :class:`TensorRef` pinned to this catalog's snapshot."""
        return TensorRef(self, self.entry(tid))

    # -- cross-tensor fetch scheduling ----------------------------------------

    def plan_many(self, requests: Sequence[Tuple[str, Optional[Sequence]]],
                  *, io: Optional["ReadExecutor"] = None) -> "FetchPlan":
        """Build ONE merged fetch plan for many ``(tid, slices)`` requests.

        Each request is a tensor id plus an optional per-axis slice list
        (``None`` = full read, same spec :meth:`TensorRef.read_slice`
        takes). Per request the codec's pushdown prunes chunk files
        exactly as a single read would; then the surviving object keys
        across ALL requests merge into one deduplicated fetch list in
        first-occurrence order — a chunk file shared by several requests
        (two slices of one tensor, or a batch's worth of adjacent rows)
        is fetched and decoded exactly once per plan. This is the paper's
        read-slice pruning lifted from one tensor to a whole batch /
        param-tree load.

        Keys resolve through :func:`~repro_torch.lake.table.physical_path`, so
        deduplicated add-actions (several logical files aliasing one
        content-addressed object) merge into a single fetch, and the
        block-cache names carry each object's content hash. Delta-stored
        files additionally contribute their **base object keys** to the
        plan: bases are prepended to ``unique_keys`` so they land in the
        block cache before any delta frame that reconstructs against
        them — the executor's inline base fetch then hits cache instead
        of issuing a nested get per delta file.
        """
        # headers drive spec normalization and every decode; warm the
        # uncached ones concurrently rather than one RTT at a time. The
        # warm-up goes through the I/O pool (fetch_ordered into the block
        # cache, then header() parses from cache), NOT the work pool —
        # plan_many may itself be running inside a work-pool job (a
        # stream-loader batch fetch) and a work-on-work wait could
        # deadlock a saturated pool.
        io = io or self._store.io
        if io.cache.capacity:
            keys = []
            for tid in dict.fromkeys(t for t, _ in requests):
                if tid in self._headers:
                    continue
                entry = self.entry(tid)
                if not entry.header_adds:
                    continue
                path = entry.header_adds[0]["path"]
                if path in self._store._headers_by_path:
                    continue
                keys.append(f"{self.table_for(entry.shard).path}/{path}")
            if len(keys) > 1:
                for _ in io.fetch_ordered(self.table_for(0).store, keys):
                    pass
        reqs: List[PlanRequest] = []
        names: Dict[str, Optional[str]] = {}      # key -> block-cache name
        base_keys: Dict[str, Optional[str]] = {}  # delta base key -> name
        for tid, slices in requests:
            entry = self.entry(tid)
            codec = get_codec(entry.layout)
            header = self.header(tid)
            spec = filters = None
            adds = entry.chunk_adds
            if slices is not None:
                if not codec.supports_slice:
                    raise NotImplementedError(
                        f"layout {entry.layout!r} does not support slice reads")
                spec = normalize_slices(header_shape(header),
                                        [_as_spec_item(s) for s in slices])
                filters = codec.slice_filters(header, spec) or None
                adds = [a for a in adds if file_overlaps(a, filters)]
            table = self.table_for(entry.shard)
            keys: List[str] = []
            for a in adds:
                k = f"{table.path}/{physical_path(a)}"
                if k not in names:
                    keys.append(k)
                    ch = a.get("contentHash")
                    names[k] = content_cache_key(ch) if ch else None
                elif k not in keys:
                    keys.append(k)  # cross-request alias, new to this request
                db = a.get("deltaBase")
                if db:
                    bh = a.get("deltaBaseHash")
                    base_keys.setdefault(
                        db, content_cache_key(bh) if bh else None)
            reqs.append(PlanRequest(tid=tid, codec=codec, spec=spec,
                                    filters=filters, keys=keys))
        seen: Dict[str, None] = {}
        total = 0
        for r in reqs:
            total += len(r.keys)
            for k in r.keys:
                seen[k] = None
        deduped = total - len(seen)
        # bases FIRST: by the time a delta frame decodes, its base bytes
        # are already block-cached (windowed fetch_ordered preserves order)
        merged: Dict[str, None] = dict.fromkeys(base_keys)
        merged.update(seen)
        unique = list(merged)
        cache_names = [names.get(k) or base_keys.get(k) for k in unique]
        return FetchPlan(requests=reqs, unique_keys=unique,
                         keys_deduped=deduped, cache_names=cache_names)

    def read_many(self, requests: Sequence[Tuple[str, Optional[Sequence]]],
                  *, window: Optional[int] = None,
                  io: Optional["ReadExecutor"] = None,
                  cache_partition: Optional[str] = None,
                  device: Any = None) -> List[Any]:
        """Read many tensors/slices through one merged fetch plan.

        The plan's unique keys stream through the shared executor's
        windowed :meth:`~repro_torch.lake.io.ReadExecutor.fetch_ordered`, so
        decode of file *k* overlaps the wire fetch of files > *k*; each
        arriving file is decoded ONCE and handed to every request that
        wanted it (with that request's own row filters), and a request's
        final codec decode runs as soon as its last file lands — not
        after the whole plan drains. Results come back in request order.

        The read holds a **lease** on this catalog's version vector for
        its duration (no :class:`TensorRef` is constructed here), so a
        concurrent vacuum cannot delete planned files mid-plan.

        ``window`` bounds outstanding gets (the stream loader's
        backpressure); None uses the executor default. ``io`` overrides
        the store's shared executor (width sweeps, a caller-owned pool);
        ``cache_partition`` routes fetched blocks into that block-cache
        priority class (the gateway pins hot base-model weights this way).
        ``device`` (``"cuda"``, ``"cpu"`` or a :class:`torch.device`;
        ``True`` means ``"cuda"``) finishes each request through the
        codec's ``decode_device`` path (see :meth:`TensorRef.read_device`),
        so results are torch tensors on that device assembled without an
        ordered full-tensor host copy; ``None`` returns numpy arrays.
        """
        if device is True:
            device = "cuda"
        io = io or self._store.io
        plan = self.plan_many(requests, io=io)
        io.stats.bump(plans=1, plan_requests=len(plan.requests),
                      plan_keys_fetched=len(plan.unique_keys),
                      plan_keys_deduped=plan.keys_deduped)
        results: List[Optional[np.ndarray]] = [None] * len(plan.requests)
        received: List[Dict[str, Dict[str, Any]]] = [{} for _ in plan.requests]
        waiting: Dict[str, List[int]] = {}
        for i, r in enumerate(plan.requests):
            for k in r.keys:
                waiting.setdefault(k, []).append(i)

        def finish(i: int) -> None:
            r = plan.requests[i]
            groups = [self.header(r.tid)]
            groups.extend(received[i][k] for k in r.keys)  # request's order
            if device is not None:
                out, info = r.codec.decode_device(groups, r.spec,
                                                  device=device)
                if info.on_device:
                    io.stats.bump(bytes_to_device=info.device_bytes)
                results[i] = out
            else:
                results[i] = (r.codec.decode(groups) if r.spec is None
                              else r.codec.decode_slice(groups, r.spec))
            received[i].clear()

        lease = self._store.leases.acquire(self.version_vector)
        try:
            for i, r in enumerate(plan.requests):
                if not r.keys:
                    finish(i)  # fully pruned (or chunkless) request
            store = self.table_for(0).store
            fetched = io.fetch_ordered(store, plan.unique_keys, window=window,
                                       cache_names=plan.cache_names or None,
                                       cache_partition=cache_partition)
            for key, data in zip(plan.unique_keys, fetched):
                waiters = waiting.get(key, ())
                if not waiters:
                    continue  # base-object prefetch: block-cached for deltas
                batch = columnar.read_table(data)
                for i in waiters:
                    r = plan.requests[i]
                    received[i][key] = filter_rows(batch, r.filters)
                    if len(received[i]) == len(r.keys):
                        finish(i)
        finally:
            lease.release()
        return results  # type: ignore[return-value]


@dataclass
class PlanRequest:
    """One request's slot in a :class:`FetchPlan`."""

    tid: str
    codec: Any
    spec: Optional[List[Tuple[int, int]]]     # normalized; None = full read
    filters: Optional[Filters]                # row-level pushdown predicate
    keys: List[str]                           # full object keys, add order

    @property
    def n_keys(self) -> int:
        """Chunk files this request needs (post-pruning)."""
        return len(self.keys)


@dataclass
class FetchPlan:
    """A merged cross-tensor fetch plan (see :meth:`Catalog.plan_many`)."""

    requests: List[PlanRequest]
    unique_keys: List[str]                    # bases first, then deduped keys
    keys_deduped: int                         # references merged away
    # per-key block-cache names (content-hash based where known), aligned
    # with unique_keys; empty on plans built before the CAS subsystem
    cache_names: List[Optional[str]] = field(default_factory=list)

    @property
    def n_fetches(self) -> int:
        """Object gets this plan will issue."""
        return len(self.unique_keys)


def _as_spec_item(x: Any) -> Optional[Tuple[int, int]]:
    """Accept the legacy per-axis form: None or an (lo, hi) pair."""
    if x is None:
        return None
    lo, hi = x
    return int(lo), int(hi)


class TensorRef:
    """Lazy, snapshot-pinned handle to one stored tensor.

    Nothing is fetched at construction. Metadata properties read (and cache)
    only the tiny header file; ``read``/``read_slice``/``read_coo`` run the
    paper's read-tensor / read-slice operations against the pinned snapshot,
    pruning chunk files via codec pushdown before fanning fetches out on the
    shared executor. ``__getitem__`` gives the numpy view of the same thing.

    Construction acquires a **lease** on the pinned version vector, which
    ``store.vacuum()`` honors: the snapshot's files cannot be deleted under
    a live ref. ``close()`` (or context-manager exit, or garbage collection
    via a weakref finalizer) releases it; reads after close still work but
    are no longer protected from maintenance.
    """

    def __init__(self, catalog: Catalog, entry: TensorEntry):
        self._catalog = catalog
        self._entry = entry
        self._lease = catalog._store.leases.acquire(catalog.version_vector)
        # GC backstop: a dropped ref must not pin its snapshot forever
        self._finalizer = weakref.finalize(self, self._lease.release)

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        """Release this ref's snapshot lease (idempotent)."""
        self._finalizer()

    @property
    def closed(self) -> bool:
        """Whether the snapshot lease has been released."""
        return not self._finalizer.alive

    def __enter__(self) -> "TensorRef":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- metadata (header-only) ------------------------------------------------

    @property
    def tensor_id(self) -> str:
        """The stored tensor's id."""
        return self._entry.tensor_id

    @property
    def layout(self) -> str:
        """Storage codec name (ftsf/coo/csr/csf/bsgs)."""
        return self._entry.layout

    @property
    def shard(self) -> int:
        """Shard table this tensor's files live in (0 on unsharded stores)."""
        return self._entry.shard

    @property
    def version(self) -> Union[int, Tuple[int, ...]]:
        """Pinned version: table version, or the version vector if sharded."""
        return self._catalog.version

    @property
    def header(self) -> Dict[str, Any]:
        """Parsed 1-row header columns (cached per snapshot)."""
        return self._catalog.header(self.tensor_id)

    @property
    def shape(self) -> Tuple[int, ...]:
        """Dense shape, from the header only (no chunk fetches)."""
        return header_shape(self.header)

    @property
    def dtype(self) -> np.dtype:
        """Element dtype, from the header only (no chunk fetches)."""
        return header_dtype(self.header)

    @property
    def ndim(self) -> int:
        """Tensor rank."""
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        """Stored bytes across this tensor's files (encoded size)."""
        return self._entry.nbytes

    @property
    def n_chunk_files(self) -> int:
        """How many chunk data files back this tensor at this snapshot."""
        return len(self._entry.chunk_adds)

    @property
    def codec(self):
        """The layout's :class:`~repro_torch.core.encodings.base.Codec`."""
        return get_codec(self.layout)

    def __repr__(self) -> str:
        return (f"TensorRef({self.tensor_id!r}, layout={self.layout!r}, "
                f"version={self.version})")

    # -- reads -----------------------------------------------------------------

    def _groups(self, filters: Optional[Filters] = None) -> List[Dict[str, Any]]:
        """Header + surviving chunk batches, fetched concurrently."""
        table = self._catalog.table_for(self._entry.shard)
        adds = [a for a in self._entry.chunk_adds if file_overlaps(a, filters)]
        groups: List[Dict[str, Any]] = [self.header]
        groups.extend(table.fetch_adds(adds, filters=filters))
        return groups

    def read(self) -> np.ndarray:
        """Full dense read (the paper's read-tensor)."""
        return self.codec.decode(self._groups())

    def read_coo(self) -> SparseCOO:
        """Sparse COO read; native when the codec supports it."""
        if self.codec.supports_coo:
            return self.codec.decode_coo(self._groups())
        return SparseCOO.from_dense(self.read())

    def read_slice(self, slices: Sequence[Optional[Tuple[int, int]]]) -> np.ndarray:
        """The paper's read-slice: codec pushdown prunes chunk files first."""
        codec = self.codec
        if not codec.supports_slice:
            raise NotImplementedError(
                f"layout {self.layout!r} does not support slice reads")
        spec = normalize_slices(self.shape, [_as_spec_item(s) for s in slices])
        filters = codec.slice_filters(self.header, spec)
        return codec.decode_slice(self._groups(filters or None), spec)

    def read_device(self, slices: Optional[Sequence] = None, *,
                    with_info: bool = False, device: Any = "cuda"):
        """Read straight into a torch tensor on ``device``.

        FTSF reads stage chunk payloads once and reorder on the device via
        ``block_gather``; COO reads scatter sparse pairs on the device via
        ``coo_scatter`` — neither materializes an ordered full tensor on
        the host. Other layouts take host decode plus one copy
        (``path="host_fallback"``). A CUDA ``device`` runs the CUDA
        kernels and raises when there is no card; ``"cpu"`` runs their
        plain versions. ``slices`` matches :meth:`read_slice`;
        ``with_info=True`` additionally returns the
        :class:`~repro_torch.lake.device.DeviceReadInfo` accounting.
        """
        codec = self.codec
        if slices is None:
            out, info = codec.decode_device(self._groups(), device=device)
        else:
            if not codec.supports_slice:
                raise NotImplementedError(
                    f"layout {self.layout!r} does not support slice reads")
            spec = normalize_slices(self.shape,
                                    [_as_spec_item(s) for s in slices])
            filters = codec.slice_filters(self.header, spec)
            out, info = codec.decode_device(self._groups(filters or None),
                                            spec, device=device)
        if info.on_device:
            self._catalog._store.io.stats.bump(
                bytes_to_device=info.device_bytes)
        return (out, info) if with_info else out

    def __getitem__(self, item: Any) -> np.ndarray:
        """Numpy-style lazy slicing: ints, contiguous slices, Ellipsis.

        ``ref[3]``, ``ref[1:4, :, 2]``, ``ref[..., 0:2]`` all map onto
        :meth:`read_slice`; integer axes are squeezed like numpy would.
        """
        spec, squeeze = self._item_to_spec(item)
        out = self.read_slice(spec)
        return out[tuple(0 if d in squeeze else slice(None)
                         for d in range(out.ndim))] if squeeze else out

    def _item_to_spec(self, item: Any):
        shape = self.shape
        items = list(item) if isinstance(item, tuple) else [item]
        if items.count(Ellipsis) > 1:
            raise IndexError("an index can only have a single ellipsis")
        if Ellipsis in items:
            i = items.index(Ellipsis)
            fill = len(shape) - (len(items) - 1)
            if fill < 0:
                raise IndexError(f"too many indices for rank {len(shape)}")
            items[i:i + 1] = [slice(None)] * fill
        if len(items) > len(shape):
            raise IndexError(f"too many indices for rank {len(shape)}")
        spec: List[Optional[Tuple[int, int]]] = []
        squeeze: List[int] = []
        for d, it in enumerate(items):
            dim = shape[d]
            if isinstance(it, (int, np.integer)):
                i = int(it) + dim if int(it) < 0 else int(it)
                if not 0 <= i < dim:
                    raise IndexError(
                        f"index {int(it)} out of bounds for axis {d} (size {dim})")
                spec.append((i, i + 1))
                squeeze.append(d)
            elif isinstance(it, slice):
                if it.step not in (None, 1):
                    raise IndexError("TensorRef slicing is contiguous (step=1)")
                lo = 0 if it.start is None else int(it.start)
                hi = dim if it.stop is None else int(it.stop)
                spec.append((lo, hi))
            else:
                raise TypeError(f"unsupported index {it!r}")
        return spec, squeeze

    # -- async -----------------------------------------------------------------

    def read_async(self, slices: Optional[Sequence] = None) -> "Future[np.ndarray]":
        """Future of :meth:`read` (or :meth:`read_slice`) on the executor.

        Runs in the executor's work pool; the chunk fetches inside fan out
        on the I/O pool, so many refs can be resolved concurrently (serve
        weight loads, checkpoint restores) without private threads.
        """
        io = self._catalog._store.io
        if slices is None:
            return io.submit(self.read)
        return io.submit(self.read_slice, slices)

    def read_coo_async(self) -> "Future[SparseCOO]":
        """Future of :meth:`read_coo` on the executor work pool."""
        return self._catalog._store.io.submit(self.read_coo)
