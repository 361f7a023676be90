"""Content-addressed chunk store: dedup index + refcounted lifecycle.

Serving millions of users means storing millions of fine-tuned/quantized
variants of a few base models, and the dominant space win there is
*cross-tensor* redundancy, not per-chunk codecs: NeurStore stores
identical tensor blocks once across models, and TStore delta-encodes a
variant against its base so the residue compresses to almost nothing.
This module is that layer for the lake:

* :func:`chunk_hash` (re-exported from :mod:`repro_torch.lake.table`) addresses
  every part file by the blake2b-160 of its **decoded** bytes — codec and
  level changes never break the address;
* :class:`ChunkIndex` maps ``content hash -> ChunkEntry`` (object key,
  stored/raw sizes, codec, delta-base) per delta table.
  ``DeltaTable.append`` consults it before uploading: a hit commits an
  add-action whose ``physPath`` references the already-stored object and
  moves **zero** bytes. The index is persisted at
  ``<table>/_cas/chunks.index.json`` (under the ``_`` metadata prefix, so
  vacuum never treats it as data) alongside the ``_catalog/`` indexes,
  and reloads lazily in fresh processes;
* reference counting falls out of the delta log itself: an object is
  live while any retained/leased snapshot holds an add-action whose
  ``path``/``physPath``/``deltaBase`` names it — ``DeltaTable.vacuum``
  computes exactly that closure, so deleting a tensor reclaims only the
  chunks nothing else shares. After a vacuum the store drops the deleted
  paths from the index (:meth:`ChunkIndex.drop_paths`) and respills it.

Collision paranoia: the index stores ``(hash, raw_size)`` and a reuse hit
must match both; entries loaded from a spilled index are additionally
verified against the object store (one HEAD) the first time they are
reused, so a stale index can never alias new data onto a vanished object.
The in-process race against a concurrent vacuum is closed by
``UploadGuard.reserve`` — vacuum *condemns* its doomed paths before
deleting, and a reuse attempt on a condemned path falls back to a fresh
upload.

Existing (pre-dedup) tables migrate with
:meth:`repro_torch.core.store.DeltaTensorStore.build_chunk_index`
(``repro.launch.gc --build-chunk-index``), which backfills the index from
the live snapshot.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple
from weakref import WeakValueDictionary

from ..lake.io import store_scope
from ..lake.object_store import ObjectNotFoundError
from ..lake.table import UploadGuard, chunk_hash, physical_path  # noqa: F401

CHUNK_INDEX_FORMAT = 1


def chunk_index_key(table_path: str) -> str:
    """Object key of a table's spilled chunk index.

    Lives under the ``_`` metadata prefix so vacuum's data-file scan
    skips it, next to ``_catalog/`` and ``_delta_log/``.
    """
    return f"{table_path.rstrip('/')}/_cas/chunks.index.json"


@dataclass
class ChunkEntry:
    """One stored chunk: where its bytes live and how they were encoded.

    ``path`` is relative to the owning table; ``size`` the stored length
    (what an aliasing add-action must record as ``size``); ``raw_size``
    the decoded length (paired with the hash for collision paranoia).
    ``codec``/``itemsize`` mirror the original add-action so an alias
    reports honest physical accounting. Delta-stored chunks carry their
    ``delta_base`` object key (+ hash) so an alias preserves the base
    dependency vacuum's liveness scan walks. ``verified`` is False for
    entries reloaded from a spilled index until their object's existence
    has been re-checked once.
    """

    path: str
    size: int
    raw_size: int
    codec: Optional[str] = None
    itemsize: int = 1
    delta_base: Optional[str] = None
    delta_base_hash: Optional[str] = None
    verified: bool = True

    def as_record(self) -> Dict[str, Any]:
        """JSON-spillable form (verification state is not persisted)."""
        rec: Dict[str, Any] = {"path": self.path, "size": int(self.size),
                               "rawSize": int(self.raw_size)}
        if self.codec:
            rec["codec"] = self.codec
            rec["itemsize"] = int(self.itemsize)
        if self.delta_base:
            rec["deltaBase"] = self.delta_base
            if self.delta_base_hash:
                rec["deltaBaseHash"] = self.delta_base_hash
        return rec

    @classmethod
    def from_record(cls, rec: Dict[str, Any]) -> "ChunkEntry":
        """Inverse of :meth:`as_record`; loaded entries start unverified."""
        return cls(path=rec["path"], size=int(rec["size"]),
                   raw_size=int(rec.get("rawSize", rec["size"])),
                   codec=rec.get("codec"),
                   itemsize=int(rec.get("itemsize", 1)),
                   delta_base=rec.get("deltaBase"),
                   delta_base_hash=rec.get("deltaBaseHash"),
                   verified=False)


class ChunkIndex:
    """Thread-safe ``content hash -> ChunkEntry`` map for one table.

    Writers consult it through :meth:`reuse` (dedup hit = add-action
    aliasing an existing object) and feed it through :meth:`record`
    (every fresh content-hashed upload). Maintenance keeps it honest:
    vacuum calls :meth:`drop_paths` for deleted objects, and
    :meth:`spill`/:meth:`ensure_loaded` persist it across processes.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._by_hash: Dict[str, ChunkEntry] = {}
        self._by_path: Dict[str, str] = {}
        self._loaded = False
        self._dirty = False
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "inserts": 0, "collisions": 0,
            "verified": 0, "verify_failures": 0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_hash)

    @property
    def dirty(self) -> bool:
        """Whether in-memory state has diverged from the spilled index."""
        with self._lock:
            return self._dirty

    # -- persistence ---------------------------------------------------------

    def ensure_loaded(self, table: Any) -> None:
        """Merge the spilled index (if any) under in-memory entries.

        One 404-tolerant get, once per process lifetime of this index.
        In-memory entries win on conflict — they are verified facts from
        this process's own uploads; spilled entries arrive unverified and
        get one existence check on first reuse.
        """
        with self._lock:
            if self._loaded:
                return
            self._loaded = True
            try:
                raw = table.store.get(chunk_index_key(table.path))
            except ObjectNotFoundError:
                return
            try:
                doc = json.loads(raw.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                return  # corrupt index: ignore; a respill will replace it
            for h, rec in doc.get("chunks", {}).items():
                if h in self._by_hash:
                    continue
                try:
                    entry = ChunkEntry.from_record(rec)
                except (KeyError, TypeError, ValueError):
                    continue
                self._by_hash[h] = entry
                self._by_path[entry.path] = h

    def spill(self, table: Any, *, force: bool = False) -> Optional[str]:
        """Persist the index next to the table's other metadata.

        Loads the spilled state first (so a partially-warm process never
        clobbers entries it hasn't seen), skips the put when nothing
        changed since the last spill (unless ``force``), and returns the
        object key written (None when skipped).
        """
        self.ensure_loaded(table)
        with self._lock:
            if not self._dirty and not force:
                return None
            doc = {"format": CHUNK_INDEX_FORMAT,
                   "chunks": {h: e.as_record()
                              for h, e in sorted(self._by_hash.items())}}
            self._dirty = False
        key = chunk_index_key(table.path)
        table.store.put(key, json.dumps(doc, separators=(",", ":"))
                        .encode("utf-8"))
        return key

    # -- write-path hooks ----------------------------------------------------

    def reuse(self, table: Any, content_hash: str, raw_size: int, *,
              guard: Optional[UploadGuard] = None
              ) -> Optional[Dict[str, Any]]:
        """Add-action fields aliasing an existing chunk, or None.

        A hit requires the hash AND raw size to match (collision
        paranoia), the entry's object to verifiably exist (spill-loaded
        entries get one HEAD here), and — when a ``guard`` is given — a
        successful reservation of the physical path (and, for
        delta-stored chunks, of the base object in the same table), which
        a concurrently-running vacuum can refuse for paths it is about to
        delete. Any failure returns None and the caller uploads fresh
        bytes; verification failures also evict the stale entry.
        """
        self.ensure_loaded(table)
        with self._lock:
            entry = self._by_hash.get(content_hash)
            if entry is None:
                self.stats["misses"] += 1
                return None
            if entry.raw_size != int(raw_size):
                self.stats["collisions"] += 1
                return None
        if not entry.verified:
            if table.store.exists(f"{table.path}/{entry.path}"):
                with self._lock:
                    entry.verified = True
                    self.stats["verified"] += 1
            else:
                with self._lock:
                    self.stats["verify_failures"] += 1
                    if self._by_hash.get(content_hash) is entry:
                        del self._by_hash[content_hash]
                        self._by_path.pop(entry.path, None)
                        self._dirty = True
                return None
        if guard is not None:
            if not guard.reserve(entry.path):
                with self._lock:
                    self.stats["misses"] += 1
                return None
        if entry.delta_base:
            # an alias of a delta-stored chunk depends on the base object
            # too; it must be pinnable in the same table or we upload fresh
            pfx = f"{table.path}/"
            if not entry.delta_base.startswith(pfx):
                return None
            if guard is not None and \
                    not guard.reserve(entry.delta_base[len(pfx):]):
                return None
        with self._lock:
            self.stats["hits"] += 1
        fields: Dict[str, Any] = {"physPath": entry.path,
                                  "size": int(entry.size)}
        if entry.codec:
            fields["codec"] = entry.codec
            fields["rawSize"] = int(entry.raw_size)
            fields["itemsize"] = int(entry.itemsize)
        if entry.delta_base:
            fields["deltaBase"] = entry.delta_base
            if entry.delta_base_hash:
                fields["deltaBaseHash"] = entry.delta_base_hash
        return fields

    def record(self, add: Dict[str, Any]) -> None:
        """Index a freshly-uploaded add-action (first entry per hash wins).

        Aliases (``physPath``) and hash-less adds are ignored — only an
        add that physically stored its own bytes defines where a content
        hash lives.
        """
        h = add.get("contentHash")
        if not h or add.get("physPath"):
            return
        with self._lock:
            if h in self._by_hash:
                return
            entry = ChunkEntry(
                path=add["path"], size=int(add["size"]),
                raw_size=int(add.get("rawSize", add["size"])),
                codec=add.get("codec"),
                itemsize=int(add.get("itemsize", 1)),
                delta_base=add.get("deltaBase"),
                delta_base_hash=add.get("deltaBaseHash"),
                verified=True)
            self._by_hash[h] = entry
            self._by_path[entry.path] = h
            self.stats["inserts"] += 1
            self._dirty = True

    # -- maintenance hooks ---------------------------------------------------

    def drop_paths(self, paths: Iterable[str]) -> List[str]:
        """Forget entries whose objects were deleted; returns their hashes.

        Called after a vacuum with the deleted relative paths, so the
        index never hands out references to reclaimed objects (and the
        caller can evict the matching content-cache entries).
        """
        dropped: List[str] = []
        with self._lock:
            for p in paths:
                h = self._by_path.pop(p, None)
                if h is None:
                    continue
                if h in self._by_hash:
                    del self._by_hash[h]
                    dropped.append(h)
                    self._dirty = True
        return dropped

    def build_from_snapshot(self, table: Any, snapshot: Any) -> int:
        """Backfill the index from a live snapshot (store migration).

        Indexes every non-header data file the snapshot references:
        adds that recorded a ``contentHash`` enter directly; older adds
        are fetched (decoded bytes) and hashed. Existing entries win —
        rerunning is idempotent. Returns the number of new entries.
        """
        self.ensure_loaded(table)
        inserted = 0
        for a in snapshot.add_actions():
            if a.get("physPath"):
                continue  # alias: its target indexes itself
            pv = a.get("partitionValues", {}) or {}
            if pv.get("kind") == "header":
                continue  # headers are tiny, latency-critical, never dedup'd
            h = a.get("contentHash")
            raw_size = int(a.get("rawSize", a.get("size", 0)))
            if h is None:
                data = table.io.fetch(table.store,
                                      f"{table.path}/{a['path']}")
                h = chunk_hash(data)
                raw_size = len(data)
            with self._lock:
                if h in self._by_hash:
                    continue
                entry = ChunkEntry(
                    path=a["path"], size=int(a.get("size", 0)),
                    raw_size=raw_size, codec=a.get("codec"),
                    itemsize=int(a.get("itemsize", 1)),
                    delta_base=a.get("deltaBase"),
                    delta_base_hash=a.get("deltaBaseHash"),
                    verified=True)
                self._by_hash[h] = entry
                self._by_path[entry.path] = h
                self.stats["inserts"] += 1
                self._dirty = True
                inserted += 1
        return inserted


# -- per-table registry ------------------------------------------------------

_registry_lock = threading.Lock()
_chunk_indexes: "WeakValueDictionary[Tuple[Any, str], ChunkIndex]" = \
    WeakValueDictionary()


def chunk_index_for(table: Any) -> ChunkIndex:
    """The shared :class:`ChunkIndex` for one physical table.

    Keyed by ``(store scope, table path)`` — two store handles over the
    same directory dedup against one index, exactly like the lease
    registry. Weakly held: it lives as long as some table/store keeps a
    reference (``DeltaTable.cas``).
    """
    key = (store_scope(table.store), table.path.rstrip("/"))
    with _registry_lock:
        idx = _chunk_indexes.get(key)
        if idx is None:
            idx = ChunkIndex()
            _chunk_indexes[key] = idx
        return idx
