"""DeltaTensorStore — the paper's system: tensors in a delta table.

``put`` encodes a tensor with one of the five codecs and lands the row
groups as parq-lite files in a single atomic commit, partitioned by
``(tensor, kind)``. Reads go through the handle API: ``open`` returns a
snapshot-pinned lazy :class:`~repro_torch.core.catalog.TensorRef` whose
``read``/``read_slice``/``read_coo``/``read_async`` are the paper's
read-tensor / read-slice operations; ``version=`` arguments give Delta time
travel. The legacy eager calls (``get``/``get_slice``/``get_coo``/...) are
kept as thin wrappers over ``open``.

Per-read metadata cost is O(1): a :class:`~repro_torch.core.catalog.Catalog` is
built once per table version (one pass over ``table.files()``) and cached,
so a burst of reads shares one snapshot walk instead of paying it per call.
All chunk fetches flow through the table's shared ``ReadExecutor``
(``repro_torch.lake.io``): surviving chunk files are fetched concurrently, decode
streams in plan order as gets complete, repeat reads hit the block cache.

Writes batch through :class:`~repro_torch.core.batch.WriteBatch`
(``with store.batch() as b: b.put(...)``): many tensors plus deletes land
in ONE atomic commit, and headers are cached only after that commit
succeeds (an abandoned batch leaves no stale state behind).

**Write scale-out**: ``DeltaTensorStore(obj, root, shards=N)`` splits the
logical store across N shard tables, each with its own delta log — an
independent commit domain, so concurrent writers whose tensors hash to
different shards never race each other's commits (see
``repro_torch.core.sharding``). Reads are transparent: the catalog merges all
shards into one namespace pinned to a per-shard *version vector*, and
refs route fetches to the right shard table. ``shards=1`` (the default)
keeps the exact pre-sharding byte layout: the table lives at ``root``
with no manifest, so every existing table opens unchanged.
"""

from __future__ import annotations

import functools
import json
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.ops import unshuffle_host
from ..lake import DeltaTable, ObjectStore, ReadExecutor, columnar
from ..lake.compression import (CompressionSpec, DeltaBase, UnknownCodecError,
                                parse_compression, set_unshuffle_kernel)
from ..lake.io import content_cache_key, get_default_executor
from ..lake.log import ObjectNotFoundError, catalog_index_key
from ..lake.table import (CompactResult, VacuumResult, chunk_hash,
                          physical_path)
from .batch import WriteBatch
from .cas import ChunkIndex, chunk_index_for
from .catalog import Catalog, ShardSource, TensorRef, build_catalog_index
from .encodings.base import SparseCOO, first_scalar, get_codec
from .leases import Lease, RetentionPolicy, lease_scope, registry_for
from .sharding import (ROUTER_ALGO, ShardRouter, load_or_init_manifest,
                       resolve_version_vector, shard_table_path)
from .sparsity import choose_layout

TARGET_FILE_BYTES = 4 << 20

MAX_CACHED_CATALOGS = 16
MAX_CACHED_HEADERS = 1024

# shard snapshots at or past this many files spill a catalog index next to
# the delta log on commit, so later Catalog.builds are one O(1) index load
# instead of an O(files) snapshot walk (None disables spilling)
DEFAULT_SPILL_THRESHOLD = 512


def _select_rows(columns: Dict[str, Any],
                 idx: Sequence[int]) -> Dict[str, Any]:
    """Row selection by (possibly reordered) index list — the variant
    path uses it to mirror a base file's chunk order exactly."""
    idx = list(idx)
    out: Dict[str, Any] = {}
    for k, v in columns.items():
        if isinstance(v, np.ndarray) and v.dtype.kind != "O":
            out[k] = v[np.asarray(idx, dtype=np.int64)] if idx else v[:0]
        else:
            out[k] = [v[i] for i in idx]
    return out


VersionArg = Union[None, int, Sequence[int]]


class DeltaTensorStore:
    """The paper's tensor store: codec-encoded tensors in delta tables.

    See the module docstring for the architecture; ``compression`` sets
    the store's default chunk-blob codec spec (e.g. ``"zlib+shuffle"``,
    see :mod:`repro_torch.lake.compression`) — recorded in the store manifest at
    create time so every later client agrees, overridable per ``put``.
    ``None`` defers to the manifest (raw bytes when it records nothing).

    ``dedup=True`` (the default) attaches a content-addressed chunk index
    (:mod:`repro_torch.core.cas`) to every shard table: an upload whose decoded
    bytes hash to an already-stored chunk commits a reference to the
    existing object instead of re-uploading, and :meth:`put_variant`
    stores fine-tuned variants as XOR deltas against their base tensor.
    Deletes stay safe either way — vacuum reference-counts physical
    objects across every retained/leased snapshot.

    ``device`` (default ``"cuda"``) is where :meth:`get_device` lands
    tensors. A CUDA device also installs the CUDA unshuffle kernel, bound
    to that device, as this process's frame-decode hook
    (:func:`repro_torch.lake.compression.set_unshuffle_kernel`); ``"cpu"``
    installs nothing.
    """

    def __init__(self, object_store: ObjectStore, root: str = "tensor_store",
                 io: Optional[ReadExecutor] = None,
                 shards: Optional[int] = None,
                 retention: Optional[RetentionPolicy] = None,
                 spill_threshold: Optional[int] = DEFAULT_SPILL_THRESHOLD,
                 compression: Union[None, str, CompressionSpec] = None,
                 dedup: bool = True, device: Any = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            set_unshuffle_kernel(functools.partial(unshuffle_host,
                                                   device=self.device))
        root = root.rstrip("/")
        self.root = root
        spec = parse_compression(compression)
        manifest = load_or_init_manifest(
            object_store, root, shards,
            retention=None if retention is None else
            {"keep_versions": retention.keep_versions,
             "ttl_s": retention.ttl_s},
            compression=None if spec is None else spec.id)
        self.shards: int = int(manifest["shards"])
        # default chunk-blob codec: explicit ctor arg > manifest > raw.
        # Reads never consult this — frames are self-describing — so a
        # store opened with any default reads any mix of codecs. A
        # manifest naming an optional codec this process lacks (zstd on
        # a stdlib-only client) therefore must not block opening: this
        # client degrades to raw writes; only an EXPLICIT ctor arg (or
        # actually decoding such a frame) raises for a missing codec.
        if spec is None and manifest.get("compression"):
            try:
                spec = parse_compression(manifest["compression"])
            except UnknownCodecError:
                spec = None
        self.compression: Optional[CompressionSpec] = \
            spec if spec is not None and spec.active else None
        # default vacuum policy: explicit ctor arg > what the store manifest
        # records (sharded stores) > keep-latest-only
        if retention is None and manifest.get("retention"):
            r = manifest["retention"]
            retention = RetentionPolicy(
                keep_versions=int(r.get("keep_versions", 1)),
                ttl_s=r.get("ttl_s"))
        self.retention = retention or RetentionPolicy()
        self.spill_threshold = spill_threshold
        # live snapshot pins: shared across every client of this physical
        # store in the process, consumed by vacuum's retention horizon
        self.leases = registry_for(lease_scope(object_store), root)
        self.router = ShardRouter(self.shards,
                                  manifest.get("router", ROUTER_ALGO))
        io = io or get_default_executor()
        if self.shards == 1:
            # unsharded: table at root itself — the pre-sharding layout
            self.tables: List[DeltaTable] = [
                DeltaTable.create(object_store, root, io=io)]
        else:
            self.tables = [
                DeltaTable.create(object_store, shard_table_path(root, i),
                                  io=io)
                for i in range(self.shards)]
        self.dedup = bool(dedup)
        if self.dedup:
            # one shared index per physical table (registry-keyed like the
            # lease registry): every client of this table in the process
            # dedups against the same map, loaded lazily from _cas/
            for t in self.tables:
                t.cas = chunk_index_for(t)
        # per-version-vector catalogs: snapshots are immutable, so a catalog
        # never goes stale; LRU-capped for long-lived many-version clients
        self._catalogs: "OrderedDict[Tuple[int, ...], Catalog]" = OrderedDict()
        # parsed headers keyed by immutable data-file path (seeded on
        # successful commits, filled on reads) — staleness-free by naming;
        # part-file names are uuid-unique, so one map covers all shards
        self._headers_by_path: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        # catalog_stats shows the O(1) metadata claim: `builds` counts
        # catalog constructions, `hits` reads served by a cached catalog,
        # `snapshot_walks` shard sources resolved by an O(files) snapshot
        # walk, `index_loads` sources resolved by a spilled catalog index
        self.catalog_stats: Dict[str, int] = {"builds": 0, "hits": 0,
                                              "snapshot_walks": 0,
                                              "index_loads": 0}
        # commit_stats shows the scale-out claim: `commits` = landed shard
        # commits, `conflicts` = CommitConflicts observed by batches,
        # `retries` = rebased re-commit attempts (see WriteBatch)
        self.commit_stats: Dict[str, int] = {"commits": 0, "conflicts": 0,
                                             "retries": 0}

    @property
    def table(self) -> DeltaTable:
        """The first (or only) shard table.

        Unsharded stores keep the old single-table API intact through this
        alias; on sharded stores it doubles as the **meta shard** that holds
        non-tensor rows (checkpoint manifests) via ``WriteBatch.add_rows``.
        """
        return self.tables[0]

    @property
    def io(self) -> ReadExecutor:
        """Shared read executor all fetches for this store go through."""
        return self.tables[0].io

    # -- catalog / handles ---------------------------------------------------

    def _concrete_vector(self, version: VersionArg) -> Tuple[int, ...]:
        """Resolve a user-facing ``version=`` to one concrete int per shard
        (``None`` entries -> that shard's latest, probed concurrently)."""
        vv = resolve_version_vector(self.shards, version)
        if all(v is not None for v in vv):
            return tuple(int(v) for v in vv)
        if self.shards == 1:
            return (self.tables[0].version() if vv[0] is None else int(vv[0]),)
        return tuple(self.io.map(
            lambda tv: tv[0].version() if tv[1] is None else int(tv[1]),
            list(zip(self.tables, vv))))

    def _shard_source(self, shard: int, version: int) -> ShardSource:
        """One shard's catalog source: spilled index if present, else walk.

        A snapshot already replayed by this client is free — use it without
        probing for an index. Otherwise try the one-get spilled index
        (written at commit time past ``spill_threshold``); on miss, fall
        back to the O(files) snapshot walk. The accounting feeds
        ``catalog_stats['snapshot_walks'/'index_loads']``.
        """
        table = self.tables[shard]
        if version < 0:
            raise ObjectNotFoundError(f"no delta table at {table.path}")
        snap = table.log.cached_snapshot(version)
        if snap is not None:
            return ShardSource(version=version, snapshot=snap)
        if self.spill_threshold is not None:
            try:
                body = self.io.fetch(table.store,
                                     catalog_index_key(table.path, version))
            except ObjectNotFoundError:
                pass
            else:
                self.catalog_stats["index_loads"] += 1
                return ShardSource(version=version, index=json.loads(body))
        self.catalog_stats["snapshot_walks"] += 1
        return ShardSource(version=version, snapshot=table.snapshot(version))

    def catalog(self, version: VersionArg = None) -> Catalog:
        """The merged tensor index at ``version`` (latest if None).

        ``version`` is an int on 1-shard stores, a per-shard version vector
        on sharded stores. O(1) when the vector is already cached; a cold
        build resolves each shard from its spilled catalog index when one
        exists (one get), else by walking the snapshot.
        """
        key = self._concrete_vector(version)
        cat = self._catalogs.get(key)
        if cat is not None:
            self.catalog_stats["hits"] += 1
            self._catalogs.move_to_end(key)
            return cat
        if self.shards == 1:
            sources = [self._shard_source(0, key[0])]
        else:
            sources = self.io.map(lambda sv: self._shard_source(*sv),
                                  list(enumerate(key)))
        cat = Catalog(self, sources)
        self.catalog_stats["builds"] += 1
        self._catalogs[key] = cat
        while len(self._catalogs) > MAX_CACHED_CATALOGS:
            self._catalogs.popitem(last=False)
        return cat

    def lease(self, version: VersionArg = None) -> Lease:
        """Pin ``version`` (latest if None) against vacuum until released.

        The refcounted pin every :class:`TensorRef` takes implicitly,
        exposed for holders that outlive any single ref — e.g. the
        checkpointer retaining its last K checkpoints.
        """
        return self.leases.acquire(self._concrete_vector(version))

    def open(self, tid: str, *, version: VersionArg = None) -> TensorRef:
        """Lazy snapshot-pinned handle; fetches nothing until read."""
        return self.catalog(version).open(tid)

    def _header_for_path(self, path: str, shard: int = 0) -> Dict[str, Any]:
        cols = self._headers_by_path.get(path)
        if cols is not None:
            self._headers_by_path.move_to_end(path)
            return cols
        table = self.tables[shard]
        data = self.io.fetch(table.store, f"{table.path}/{path}")
        cols = columnar.read_table(data)
        self._seed_header(path, cols)
        return cols

    def _seed_header(self, path: str, cols: Dict[str, Any]) -> None:
        self._headers_by_path[path] = cols
        while len(self._headers_by_path) > MAX_CACHED_HEADERS:
            self._headers_by_path.popitem(last=False)

    # -- maintenance ---------------------------------------------------------

    def _maybe_spill(self, shard: int, version: int,
                     adds_hint: Optional[int] = None) -> bool:
        """Spill the catalog index for a freshly committed shard version
        when the snapshot has crossed ``spill_threshold`` files.

        Cheap guard first: when the committer's previous snapshot is still
        cached and ``adds_hint`` (how many files the commit added) proves
        the threshold cannot have been crossed, skip without any replay —
        small stores never pay a spill probe on their commit path.
        """
        if self.spill_threshold is None:
            return False
        table = self.tables[shard]
        if adds_hint is not None:
            prev = table.log.cached_snapshot(version - 1)
            if prev is not None and \
                    len(prev.files) + adds_hint < self.spill_threshold:
                return False
        snap = table.snapshot(version)
        if len(snap.files) < self.spill_threshold:
            return False
        self._spill_index(table, snap)
        return True

    def _spill_index(self, table: DeltaTable, snap) -> None:
        body = json.dumps(build_catalog_index(snap),
                          separators=(",", ":")).encode("utf-8")
        # plain put: content is deterministic per version, so a racing
        # re-spill writes identical bytes — last writer wins harmlessly
        table.store.put(catalog_index_key(table.path, snap.version), body)
        # the chunk index spills alongside the catalog indexes, so a fresh
        # process dedups against everything this one stored
        idx = getattr(table, "cas", None)
        if idx is not None:
            idx.spill(table)

    def spill_catalog(self, version: VersionArg = None) -> List[str]:
        """Force-write the per-shard catalog index at ``version`` (latest
        if None), regardless of threshold; returns the keys written.
        Operators use this to backfill indexes onto pre-existing tables."""
        key = self._concrete_vector(version)
        written = []
        for shard, v in enumerate(key):
            table = self.tables[shard]
            self._spill_index(table, table.snapshot(v))
            written.append(catalog_index_key(table.path, v))
        return written

    def _evict_headers(self, paths: Sequence[str]) -> None:
        for p in paths:
            self._headers_by_path.pop(p, None)

    def compact(self, *, recompress: Union[None, str, CompressionSpec] = None,
                ) -> List[CompactResult]:
        """OPTIMIZE every shard table (fanned out on the executor).

        Rewritten files keep their codec; ``recompress="zlib+shuffle"``
        re-encodes every non-header data file under that codec instead —
        the in-place migration path for stores written before compression
        existed (exposed as ``repro.launch.gc --recompress``). Live leased
        snapshots keep reading their original bytes: compact adds files,
        vacuum is what eventually deletes the old generation.

        Compacted-away paths are evicted from the header and block caches —
        their bytes survive until vacuum, but a stale cache entry must not
        mask a storage-level problem. No-op shards commit nothing.
        """
        spec = parse_compression(recompress)
        if self.shards == 1:
            results = [self.tables[0].compact(recompress=spec)]
        else:
            results = self.io.map(lambda t: t.compact(recompress=spec),
                                  self.tables)
        for shard, res in enumerate(results):
            if not res:
                continue
            table = self.tables[shard]
            self._evict_headers(res.removed_paths)
            table.io.invalidate(table.store,
                                [f"{table.path}/{p}" for p in res.removed_paths])
            self._maybe_spill(shard, res.version)
        return results

    def _retention_horizon(self, shard: int, latest: int,
                           keep_versions: int,
                           ttl_s: Optional[float]) -> int:
        """Oldest version this shard must keep under the policy (leases are
        added on top by the caller)."""
        horizon = max(0, latest - (keep_versions - 1))
        if ttl_s is not None:
            cutoff = time.time() - ttl_s
            log = self.tables[shard].log
            v = horizon
            while v > 0:
                ts = log.commit_ts(v - 1)
                if ts is None or ts < cutoff:
                    break
                v -= 1
            horizon = v
        return horizon

    def vacuum(self, *, keep_versions: Optional[int] = None,
               ttl_s: Optional[float] = None,
               dry_run: bool = False) -> List[VacuumResult]:
        """Delete files unreachable from any retained or leased snapshot.

        Per shard, the retention horizon keeps the newest
        ``keep_versions`` versions (default: the store's
        :class:`~repro_torch.core.leases.RetentionPolicy`) plus every version
        younger than ``ttl_s``; versions pinned by live leases — every open
        :class:`TensorRef`, every checkpoint retained by the checkpointer —
        are kept whatever their age, so pinned reads and time travel within
        the horizon keep working. Deleted paths are evicted from the block
        and header caches, and catalogs cached for now-unreachable versions
        are dropped. ``dry_run`` reports without deleting.

        With dedup, deletes are effectively **reference-counted**: each
        shard table keeps an object while any retained/leased add-action
        references it by path, ``physPath`` alias, or ``deltaBase``.
        Sharded stores additionally pre-scan every shard's retained
        snapshots for *cross-shard* delta-base references (a variant's
        files may delta against a base tensor routed to another shard)
        and pass them to the owning shard as extra live paths. After
        deleting, each shard's chunk index drops the reclaimed paths (so
        dedup never hands out dangling references), the matching
        content-cache entries are evicted, and the index respills.
        """
        keep = self.retention.keep_versions if keep_versions is None \
            else max(1, int(keep_versions))
        ttl = self.retention.ttl_s if ttl_s is None else ttl_s

        plans = []
        for shard in range(self.shards):
            table = self.tables[shard]
            latest = table.version()
            horizon = self._retention_horizon(shard, latest, keep, ttl)
            leased = sorted(self.leases.leased_versions(shard))
            plans.append((table, horizon, leased))

        extra_live: Dict[int, set] = {i: set() for i in range(self.shards)}
        if self.shards > 1:
            # cross-shard delta-base closure: deltaBase keys are absolute,
            # so prefix-match them to the owning shard table (the trailing
            # "/" keeps shard-1 from matching shard-10)
            prefixes = [(t.path + "/", i) for i, t in enumerate(self.tables)]
            for shard, (table, horizon, leased) in enumerate(plans):
                retained = table.retained_versions(horizon=horizon,
                                                   extra_versions=leased)
                for v in sorted(retained):
                    for a in table.log.snapshot(v).files.values():
                        db = a.get("deltaBase")
                        if not db:
                            continue
                        for pfx, owner in prefixes:
                            if owner != shard and db.startswith(pfx):
                                extra_live[owner].add(db[len(pfx):])
                                break

        def one(shard: int) -> VacuumResult:
            table, horizon, leased = plans[shard]
            return table.vacuum(horizon=horizon,
                                extra_versions=leased,
                                extra_live=sorted(extra_live[shard]),
                                dry_run=dry_run)

        if self.shards == 1:
            results = [one(0)]
        else:
            results = self.io.map(one, list(range(self.shards)))
        if not dry_run:
            for shard, res in enumerate(results):
                table = self.tables[shard]
                self._evict_headers(res.deleted_paths)
                # catalogs pinned outside this shard's retained set now
                # reference deleted files — drop them from the cache
                # (pop, not del: a concurrent reader may race the LRU)
                retained = set(res.retained_versions)
                for key in [k for k in self._catalogs
                            if k[shard] not in retained]:
                    self._catalogs.pop(key, None)
                idx = getattr(table, "cas", None)
                if idx is None:
                    continue
                if res.deleted_paths:
                    idx.ensure_loaded(table)
                    dropped = idx.drop_paths(res.deleted_paths)
                    if dropped:
                        self.io.invalidate(
                            table.store,
                            [content_cache_key(h) for h in dropped])
                if idx.dirty:
                    idx.spill(table)
        return results

    # -- write -------------------------------------------------------------

    def _resolve_tid(self, tensor: Any, layout: str,
                     tensor_id: Optional[str]) -> Tuple[str, str]:
        """Resolve (layout, tensor_id) without encoding or uploading anything,
        so callers can run existence checks before paying any upload."""
        if layout == "auto":
            layout = choose_layout(tensor)
        get_codec(layout)  # fail fast on unknown layouts
        return layout, tensor_id or f"{layout}-{uuid.uuid4().hex[:12]}"

    def shard_of(self, tensor_id: str) -> int:
        """Shard index the router assigns ``tensor_id`` (0 when unsharded)."""
        return self.router.shard_of(tensor_id)

    def _tensor_itemsize(self, tensor: Any) -> int:
        """Dtype width of ``tensor`` — what the byte-shuffle filter
        transposes on. SparseCOO carriers report their values' dtype."""
        dt = getattr(tensor, "dtype", None)
        if dt is None:
            dt = getattr(getattr(tensor, "values", None), "dtype", None)
        if dt is None:
            dt = np.asarray(tensor).dtype
        return np.dtype(dt).itemsize

    def _encode_and_upload(self, tensor: Any, *, layout: str,
                           tensor_id: str,
                           target_file_bytes: Optional[int] = None,
                           guard=None,
                           compression: Union[None, str, CompressionSpec] = None,
                           **codec_params):
        """Encode + upload part files (no commit). ``layout``/``tensor_id``
        must already be resolved (see :meth:`_resolve_tid`). Returns
        ``(shard, add_actions, header_seed)`` where ``shard`` is the router-
        assigned shard the files were uploaded into and header_seed is
        ``(path, columns)`` for post-commit caching, or None. ``guard`` (an
        :class:`~repro_torch.lake.table.UploadGuard`) registers each upload so
        concurrent vacuum spares the not-yet-committed files.

        ``compression`` overrides the store default for this tensor's
        chunk files; headers always land raw (tiny, latency-critical, and
        a codec-less client must still be able to stat shapes).

        When the store dedups, every non-header file is offered to the
        shard table's chunk index: content already stored commits as a
        reference, moving zero bytes (checkpoint re-uploads of unchanged
        tensors collapse this way). One ``dedup_seen`` set spans the whole
        tensor so its own files never alias each other."""
        codec = get_codec(layout)
        tid = tensor_id
        shard = self.router.shard_of(tid)
        table = self.tables[shard]
        target = TARGET_FILE_BYTES if target_file_bytes is None else target_file_bytes
        spec = parse_compression(compression)
        if spec is None:
            spec = self.compression
        itemsize = self._tensor_itemsize(tensor) if spec is not None else 1
        groups = codec.encode(tensor, **{k: v for k, v in codec_params.items()
                                         if v is not None})
        adds: List[Dict[str, Any]] = []
        header_seed = None
        dedup_seen: set = set()
        for grp in groups:
            grp_spec = spec if grp.kind != "header" else None
            cas = table.cas if grp.kind != "header" else None
            adds.extend(self._append_rows(
                table, grp.columns, tid=tid, kind=grp.kind, layout=layout,
                spec=grp_spec, itemsize=itemsize, target=target, guard=guard,
                cas=cas, dedup_seen=dedup_seen))
            if grp.kind == "header":
                header_seed = (adds[-1]["path"], grp.columns)
        return shard, adds, header_seed

    def _append_rows(self, table: DeltaTable, columns: Dict[str, Any], *,
                     tid: str, kind: str, layout: str, spec, itemsize: int,
                     target: int, guard=None, cas: Optional[ChunkIndex] = None,
                     dedup_seen: Optional[set] = None) -> List[Dict[str, Any]]:
        """Split ``columns`` into ~``target``-byte part files and upload
        them (no commit) under the tensor's partition values — a thin
        wrapper over :meth:`~repro_torch.lake.table.DeltaTable.append_split`."""
        return table.append_split(
            columns, target_bytes=target, guard=guard, compression=spec,
            shuffle_itemsize=itemsize, cas=cas, dedup_seen=dedup_seen,
            partition_values={"tensor": tid, "kind": kind, "layout": layout})

    def _encode_and_upload_variant(self, tensor: Any, *, base_tid: str,
                                   tensor_id: str, guard_for,
                                   target_file_bytes: Optional[int] = None,
                                   compression: Union[None, str,
                                                      CompressionSpec] = None):
        """Encode ``tensor`` as a delta-stored variant of ``base_tid``.

        The variant's chunk rows are re-partitioned to mirror the base
        tensor's chunk files (aligned row-by-row on ``chunk_index``), so
        each variant file XOR-diffs against exactly one existing base
        object — a fine-tune that perturbs a few percent of values
        compresses to near-nothing, and chunks identical to the base
        dedup into pure references before any delta is even encoded.
        Rows no base file covers (grown tensors, layouts without a
        ``chunk_index`` column) fall back to the plain upload path, as
        does the header. Delta-stored files never target another delta
        (vacuum's liveness closure stays single-hop by construction:
        only base adds without ``deltaBase`` are eligible anchors).

        ``guard_for(shard)`` supplies the upload guard per shard — the
        base tensor may route to a different shard than the variant, and
        its referenced objects must stay pinned through the commit
        window. Returns ``(shard, adds, header_seed)`` like
        :meth:`_encode_and_upload`.
        """
        cat = self.catalog()
        entry = cat.entry(base_tid)
        layout = entry.layout
        codec = get_codec(layout)
        tid = tensor_id
        shard = self.router.shard_of(tid)
        table = self.tables[shard]
        base_table = self.tables[entry.shard]
        target = TARGET_FILE_BYTES if target_file_bytes is None \
            else target_file_bytes
        spec = parse_compression(compression)
        if spec is None:
            spec = self.compression
        if spec is None or not spec.active:
            spec = parse_compression("zlib")  # deltas need a codec to win
        itemsize = self._tensor_itemsize(tensor)
        params: Dict[str, Any] = {}
        try:
            header = cat.header(base_tid)
        except (KeyError, ObjectNotFoundError):
            header = None
        if header is not None and "chunk_dim_count" in header:
            # chunk the variant exactly like its base, or rows won't align
            params["chunk_dims"] = int(first_scalar(header["chunk_dim_count"]))
        guard = guard_for(shard)
        base_guard = guard_for(entry.shard) if entry.shard != shard else guard
        lease = self.leases.acquire(cat.version_vector)
        try:
            groups = codec.encode(tensor, **params)
            dedup_seen: set = set()
            adds: List[Dict[str, Any]] = []
            header_seed = None
            eligible = [a for a in entry.chunk_adds if not a.get("deltaBase")]
            base_keys = [f"{base_table.path}/{physical_path(a)}"
                         for a in eligible]
            base_names = [content_cache_key(a["contentHash"])
                          if a.get("contentHash") else None for a in eligible]
            base_blobs = list(self.io.fetch_ordered(
                base_table.store, base_keys,
                cache_names=base_names)) if eligible else []
            for grp in groups:
                if grp.kind == "header":
                    add = table.append(
                        grp.columns, commit=False, guard=guard,
                        partition_values={"tensor": tid, "kind": "header",
                                          "layout": layout})
                    adds.append(add)
                    header_seed = (add["path"], grp.columns)
                    continue
                cols = grp.columns
                rows = len(next(iter(cols.values())))
                covered = np.zeros(rows, dtype=bool)
                order_col = cols.get("chunk_index")
                if order_col is not None and len(base_blobs):
                    index_of = {int(ci): i
                                for i, ci in enumerate(order_col)}
                    for base_add, base_key, blob in zip(eligible, base_keys,
                                                        base_blobs):
                        base_order = columnar.read_table(
                            blob, ["chunk_index"]).get("chunk_index")
                        if base_order is None or len(base_order) == 0:
                            continue
                        sel = [index_of.get(int(ci)) for ci in base_order]
                        if any(i is None or covered[i] for i in sel):
                            # this base file covers rows the variant lacks
                            # (or rows already taken): no clean 1:1 diff
                            continue
                        aligned = _select_rows(cols, sel)
                        bh = base_add.get("contentHash") or chunk_hash(blob)
                        add = table.append(
                            aligned, commit=False, guard=guard,
                            compression=spec, shuffle_itemsize=itemsize,
                            cas=table.cas, dedup_seen=dedup_seen,
                            delta_base=DeltaBase(key=base_key, data=blob,
                                                 content_hash=bh),
                            partition_values={"tensor": tid,
                                              "kind": grp.kind,
                                              "layout": layout})
                        if add.get("deltaBase") == base_key:
                            # the commit will reference the base object:
                            # pin it through the commit window even if the
                            # base tensor is concurrently deleted+vacuumed
                            base_guard.add(physical_path(base_add))
                        adds.append(add)
                        covered[np.asarray(sel, dtype=np.int64)] = True
                if not covered.all():
                    leftover = cols if not covered.any() else \
                        _select_rows(cols, np.flatnonzero(~covered))
                    adds.extend(self._append_rows(
                        table, leftover, tid=tid, kind=grp.kind,
                        layout=layout, spec=spec, itemsize=itemsize,
                        target=target, guard=guard, cas=table.cas,
                        dedup_seen=dedup_seen))
            return shard, adds, header_seed
        finally:
            lease.release()

    def put_deferred(self, tensor: Any, *, layout: str = "auto",
                     tensor_id: Optional[str] = None,
                     target_file_bytes: int = TARGET_FILE_BYTES,
                     compression: Union[None, str, CompressionSpec] = None,
                     **codec_params) -> List[Dict[str, Any]]:
        """Upload part files WITHOUT committing; returns add-actions.

        Low-level two-phase building block (callers pass the adds to
        ``table.commit_adds`` themselves — on a sharded store that table is
        ``store.tables[store.shard_of(tid)]``). Prefer :meth:`batch`, which
        also handles overwrites/deletes, shard routing, and post-commit
        header caching. Note no header is cached here — an abandoned upload
        must leave no trace.
        """
        layout, tid = self._resolve_tid(tensor, layout, tensor_id)
        _shard, adds, _ = self._encode_and_upload(
            tensor, layout=layout, tensor_id=tid,
            target_file_bytes=target_file_bytes, compression=compression,
            **codec_params)
        return adds

    def batch(self, *, op: str = "WRITE BATCH",
              commit_retries: Optional[int] = None) -> WriteBatch:
        """Stage many puts/deletes; commit atomically per shard.

        On an unsharded store the whole batch is ONE commit. On a sharded
        store staged actions split by shard and land as one atomic commit
        per touched shard, each fenced against the batch's base snapshot
        with a bounded commit-retry/rebase loop on ``CommitConflict``
        (``commit_retries`` bounds it; see :class:`WriteBatch`).
        """
        return WriteBatch(self, op=op, commit_retries=commit_retries)

    def put(self, tensor: Any, *, layout: str = "auto", tensor_id: Optional[str] = None,
            overwrite: bool = False, target_file_bytes: int = TARGET_FILE_BYTES,
            compression: Union[None, str, CompressionSpec] = None,
            **codec_params) -> str:
        """Store one tensor in its own atomic commit; returns its id.

        ``layout`` picks the encoding codec (``"auto"`` = the 10% sparsity
        policy); ``compression`` overrides the store's default chunk-blob
        codec for this tensor (e.g. ``"zlib+shuffle"``). Raises
        ``ValueError`` if ``tensor_id`` exists and ``overwrite`` is False.
        Sugar for a one-put :meth:`batch`.
        """
        with self.batch(op="PUT TENSOR") as b:
            tid = b.put(tensor, layout=layout, tensor_id=tensor_id,
                        overwrite=overwrite, target_file_bytes=target_file_bytes,
                        compression=compression, **codec_params)
        return tid

    def put_variant(self, tensor: Any, *, base_tid: str,
                    tensor_id: Optional[str] = None,
                    overwrite: bool = False,
                    target_file_bytes: int = TARGET_FILE_BYTES,
                    compression: Union[None, str, CompressionSpec] = None,
                    ) -> str:
        """Store ``tensor`` as a delta-encoded variant of ``base_tid``.

        The fine-tuned-model write path: chunks identical to the base
        dedup into pure references, differing chunks store as XOR deltas
        against the base's objects (reconstructed transparently on read).
        The variant is an ordinary tensor afterwards — same handles, same
        reads, same deletes; vacuum keeps the base objects alive while
        any retained variant references them. Returns the variant's id
        (default ``"<base_tid>~<hex>"``). Sugar for a one-put
        :meth:`batch` using :meth:`WriteBatch.put_variant`.
        """
        with self.batch(op="PUT VARIANT") as b:
            tid = b.put_variant(tensor, base_tid=base_tid,
                                tensor_id=tensor_id, overwrite=overwrite,
                                target_file_bytes=target_file_bytes,
                                compression=compression)
        return tid

    def delete(self, tid: str) -> None:
        """Remove ``tid``'s files from the latest snapshot (one commit).

        Older snapshots still see the tensor until :meth:`vacuum`; missing
        ids are a no-op (sugar for a one-delete :meth:`batch`).
        """
        with self.batch(op="DELETE TENSOR") as b:
            b.delete(tid, missing_ok=True)

    # -- read (legacy eager wrappers over the handle API) --------------------

    def get(self, tid: str, *, version: VersionArg = None) -> np.ndarray:
        """Eager full read of ``tid`` at ``version`` (latest if None)."""
        with self.open(tid, version=version) as ref:
            return ref.read()

    def get_coo(self, tid: str, *, version: VersionArg = None) -> SparseCOO:
        """Eager sparse read (native when the layout supports COO)."""
        with self.open(tid, version=version) as ref:
            return ref.read_coo()

    def get_slice(self, tid: str, slices: Sequence[Optional[Tuple[int, int]]], *,
                  version: VersionArg = None) -> np.ndarray:
        """Eager read-slice (the paper's Eq. (2) leading-dims window)."""
        with self.open(tid, version=version) as ref:
            return ref.read_slice(slices)

    def get_device(self, tid: str,
                   slices: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
                   *, version: VersionArg = None, device: Any = None):
        """Eager device read: the tensor (or leading-dims slice) as a torch
        tensor on ``device`` (the store's, ``"cuda"`` by default),
        assembled without an ordered full-tensor host copy (see
        :meth:`~repro_torch.core.catalog.TensorRef.read_device`)."""
        with self.open(tid, version=version) as ref:
            return ref.read_device(slices, device=device or self.device)

    def read_many(self, requests: Sequence[Tuple[str, Optional[Sequence]]], *,
                  version: VersionArg = None,
                  window: Optional[int] = None,
                  io: Optional[ReadExecutor] = None,
                  cache_partition: Optional[str] = None,
                  device: Any = None) -> List[Any]:
        """Read many ``(tid, slices)`` requests through ONE merged fetch
        plan (see :meth:`~repro_torch.core.catalog.Catalog.read_many`): shared
        chunk keys are fetched once, adjacent requests' files stream
        through the windowed executor, and each request decodes as soon
        as its last file lands. ``slices=None`` reads a tensor in full.
        Results come back in request order, all pinned to one snapshot.
        ``io`` overrides the shared executor; ``cache_partition`` names
        the block-cache priority class the fetched blocks land in;
        ``device`` (``"cuda"``, ``"cpu"``, or ``True`` for ``"cuda"``)
        assembles each result as a torch tensor on that device.
        """
        return self.catalog(version).read_many(
            requests, window=window, io=io, cache_partition=cache_partition,
            device=device)

    def ingest(self, tensor_id: str, *, watermark_rows: int = 64,
               watermark_s: Optional[float] = None,
               target_file_bytes: Optional[int] = None,
               compression: Union[None, str, CompressionSpec] = None,
               commit_retries: Optional[int] = None,
               clock=None):
        """A streaming :class:`~repro_torch.data.ingest.IngestWriter` on ``tensor_id``.

        ``writer.append_rows(rows)`` buffers sample rows and commits them
        as grown FTSF chunk files whenever ``watermark_rows`` rows (or
        ``watermark_s`` seconds of buffer age) accumulate — each flush is
        one fenced atomic commit through the two-phase upload path, so
        concurrent batch writers, ``compact``, ``vacuum``, and epoch-pinned
        readers all keep working. The tensor is created on first flush if
        it does not exist (row shape/dtype inferred from the first rows).
        """
        from ..data.ingest import IngestWriter  # data sits above core
        return IngestWriter(self, tensor_id, watermark_rows=watermark_rows,
                            watermark_s=watermark_s,
                            target_file_bytes=target_file_bytes,
                            compression=compression,
                            commit_retries=commit_retries, clock=clock)

    def models(self, prefix: str, *, version: VersionArg = None):
        """A :class:`~repro_torch.serve.repo.ModelRepo` handle over ``prefix``.

        The serving-weights API: ``repo.save(params)`` persists a param
        tree (one tensor per leaf, one atomic commit),
        ``repo.load(template)`` reads it onto the store's device through
        one merged fetch plan, ``repo.open_variant(name)`` stores
        fine-tunes as delta variants of this repo's leaves. The repo is
        snapshot-pinned and lease-holding like :class:`TensorRef`.
        """
        from ..serve.repo import ModelRepo  # serve sits above core
        return ModelRepo(self, prefix, version=version)

    # -- catalog conveniences -------------------------------------------------

    def list_tensors(self, version: VersionArg = None) -> List[Tuple[str, str]]:
        """Sorted ``(tensor_id, layout)`` pairs at ``version``."""
        return self.catalog(version).tensors()

    def shape_of(self, tid: str, *, version: VersionArg = None) -> Tuple[int, ...]:
        """Dense shape from the header only (one tiny fetch, cached)."""
        with self.open(tid, version=version) as ref:
            return ref.shape

    def tensor_bytes(self, tid: str, *, version: VersionArg = None) -> int:
        """Stored bytes across the tensor's files (no data fetches)."""
        with self.open(tid, version=version) as ref:
            return ref.nbytes

    def storage_stats(self, version: VersionArg = None) -> Dict[str, Any]:
        """Logical vs physical vs *deduplicated* bytes at ``version`` —
        the paper's space-efficiency claim, measurable.

        Walks the (cached) catalog's add-actions, so it costs no data
        fetches. Physical bytes count each stored object **once**, however
        many add-actions reference it — the honest answer dedup demands.
        Returns::

            {"tensors": int, "files": int,
             "physical_bytes": int,   # unique stored objects, stored size
             "referenced_bytes": int, # sum over references (pre-dedup view)
             "logical_bytes": int,    # pre-compression file bytes
             "ratio": float,          # logical / physical  (>= 1.0 good)
             "compression": str,      # the store's default codec spec
             "by_codec": {codec_id: {"files", "physical_bytes",
                                     "logical_bytes", "ratio"}},
             "dedup": {"unique_chunks", "references", "deduped_refs",
                       "saved_bytes",   # referenced - physical
                       "delta_files"}}  # files stored as XOR deltas

        Files written before compression existed count under codec
        ``"none"`` with ratio 1.0 — so a half-migrated store shows exactly
        how much of it still holds raw bytes (what ``gc --recompress``
        would win).
        """
        cat = self.catalog(version)
        by_codec: Dict[str, Dict[str, Any]] = {}
        seen_objects: set = set()
        files = physical = referenced = logical = 0
        deduped_refs = delta_files = 0
        for tid in cat:
            entry = cat.entry(tid)
            for add in entry.header_adds + entry.chunk_adds:
                codec = add.get("codec", "none")
                phys = int(add.get("size", 0))
                logi = int(add.get("rawSize", phys))
                obj = (entry.shard, physical_path(add))
                unique = obj not in seen_objects
                seen_objects.add(obj)
                rec = by_codec.setdefault(
                    codec, {"files": 0, "physical_bytes": 0,
                            "logical_bytes": 0})
                rec["files"] += 1
                rec["logical_bytes"] += logi
                files += 1
                referenced += phys
                logical += logi
                if unique:
                    rec["physical_bytes"] += phys
                    physical += phys
                else:
                    deduped_refs += 1
                if add.get("deltaBase") and unique:
                    delta_files += 1
        for rec in by_codec.values():
            rec["ratio"] = (rec["logical_bytes"] / rec["physical_bytes"]
                            if rec["physical_bytes"] else 1.0)
        return {"tensors": len(cat), "files": files,
                "physical_bytes": physical,
                "referenced_bytes": referenced,
                "logical_bytes": logical,
                "ratio": logical / physical if physical else 1.0,
                "compression": self.compression.id if self.compression
                else "none",
                "by_codec": by_codec,
                "dedup": {"unique_chunks": len(seen_objects),
                          "references": files,
                          "deduped_refs": deduped_refs,
                          "saved_bytes": referenced - physical,
                          "delta_files": delta_files}}

    def dedup_stats(self) -> Dict[str, Any]:
        """Chunk-index counters aggregated across shards::

            {"enabled": bool, "entries": int,
             "hits", "misses", "inserts", "collisions",
             "verified", "verify_failures"}

        ``hits`` are uploads that became pure references (zero bytes
        moved); ``collisions`` are hash matches rejected on raw-size
        mismatch (the paranoia check firing).
        """
        out: Dict[str, Any] = {"enabled": self.dedup, "entries": 0,
                               "hits": 0, "misses": 0, "inserts": 0,
                               "collisions": 0, "verified": 0,
                               "verify_failures": 0}
        for t in self.tables:
            idx = getattr(t, "cas", None)
            if idx is None:
                continue
            out["entries"] += len(idx)
            for k, v in idx.stats.items():
                out[k] += v
        return out

    def build_chunk_index(self) -> List[int]:
        """Backfill every shard's chunk index from its live snapshot.

        The migration path for stores written before dedup existed
        (``repro.launch.gc --build-chunk-index``): adds without a
        recorded ``contentHash`` are fetched and hashed, the index is
        spilled, and — when the store dedups — future uploads reuse the
        backfilled chunks. Idempotent. Returns per-shard counts of new
        entries.
        """
        counts: List[int] = []
        for table in self.tables:
            idx = getattr(table, "cas", None) or chunk_index_for(table)
            n = idx.build_from_snapshot(table, table.snapshot())
            idx.spill(table)
            counts.append(n)
        return counts

    def io_stats(self) -> Dict[str, Any]:
        """Read-path counters + per-request latency percentiles — the
        ``catalog_stats``-style report for the executor this store's
        fetches run through (shared across stores when it is the process
        default executor). Latencies are virtual-clock durations on a
        modeled object store, wall clock otherwise::

            {"gets", "cache_hits", "cache_misses",
             "hedges_launched", "hedges_won",
             "plans", "plan_requests",          # read_many scheduling
             "plan_keys_fetched", "plan_keys_deduped",
             "decode_s", "decode_overlap_frac", # staged frame decode
             "decodes_offloaded", "bytes_to_device",
             "latency": {"count", "mean_s", "p50_s", "p95_s",
                         "p99_s", "max_s"}}
        """
        s = self.io.stats
        return {"gets": s.gets, "cache_hits": s.cache_hits,
                "cache_misses": s.cache_misses,
                "hedges_launched": s.hedges_launched,
                "hedges_won": s.hedges_won,
                "plans": s.plans, "plan_requests": s.plan_requests,
                "plan_keys_fetched": s.plan_keys_fetched,
                "plan_keys_deduped": s.plan_keys_deduped,
                "deltas_reconstructed": s.deltas_reconstructed,
                "decode_s": s.decode_s,
                "decode_overlap_frac": s.decode_overlap_frac,
                "decodes_offloaded": s.decodes_offloaded,
                "bytes_to_device": s.bytes_to_device,
                "latency": s.latency.summary()}

    def version(self) -> Union[int, Tuple[int, ...]]:
        """Latest version: an int (1-shard) or the per-shard version vector."""
        if self.shards == 1:
            return self.tables[0].version()
        return self.version_vector()

    def version_vector(self) -> Tuple[int, ...]:
        """Latest per-shard versions, probed concurrently on the executor."""
        if self.shards == 1:
            return (self.tables[0].version(),)
        return tuple(self.io.map(lambda t: t.version(), self.tables))
