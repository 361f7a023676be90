"""Sharded logical store: route tensors across N independent delta tables.

The paper's store commits every write through ONE delta log, so the
put-if-absent commit race on ``_delta_log/<version>.json`` is the
scalability wall under many concurrent writers: all of them serialize on a
single optimistic-append domain. Deep Lake scales its lakehouse by
partitioning tensor data across independent chunked objects; NeurStore
gives each tenant an isolated write domain. This module brings that model
here: one *logical* store is backed by ``N`` shard tables, each with its
own ``_delta_log`` — commits on different shards never race each other.

* :class:`ShardRouter` — a **stable** hash of ``tensor_id`` picks the shard.
  Stability matters twice: across processes (``hash()`` is salted per
  interpreter, so it would scatter a tensor's reads away from its writes)
  and across time (N is fixed at store-create time, recorded in the store
  manifest, and never changes — resharding would need a rewrite).
* :func:`load_or_init_manifest` — the tiny JSON manifest at
  ``<root>/_store_manifest.json`` records the shard count and router algo.
  A 1-shard store writes **no manifest** and keeps its table at ``<root>``
  itself, byte-for-byte the pre-sharding layout, so every existing table
  opens unchanged and old clients can read what a ``shards=1`` client
  writes. Manifest creation is put-if-absent: two clients racing to create
  the same sharded store converge on one manifest.

A logical snapshot of a sharded store is a **version vector** — one delta
version per shard, e.g. ``(3, 5, 4, 4)`` for 4 shards. Shard commits are
independent, so there is no single total order across shards; pinning a
vector is the cross-shard consistency primitive (see ``Catalog``).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

from ..lake.object_store import (ObjectNotFoundError, ObjectStore,
                                 PutIfAbsentError)

MANIFEST_NAME = "_store_manifest.json"
ROUTER_ALGO = "blake2b64"
MANIFEST_FORMAT = 1

# a store.version() / catalog.version for a sharded store: one entry per shard
VersionVector = Tuple[int, ...]


def manifest_key(root: str) -> str:
    """Object key of the store manifest under ``root``."""
    return f"{root.rstrip('/')}/{MANIFEST_NAME}"


def shard_table_path(root: str, shard: int) -> str:
    """Shard tables live under the logical root, one directory per shard."""
    return f"{root.rstrip('/')}/shard-{shard:05d}"


@dataclass(frozen=True)
class ShardRouter:
    """Stable ``tensor_id -> shard`` mapping, fixed at store-create time."""

    shards: int
    algo: str = ROUTER_ALGO

    def __post_init__(self):
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.algo != ROUTER_ALGO:
            raise ValueError(f"unknown shard router algo {self.algo!r} "
                             f"(this client supports {ROUTER_ALGO!r})")

    def shard_of(self, tensor_id: str) -> int:
        """Shard index for ``tensor_id`` (stable across processes)."""
        if self.shards == 1:
            return 0
        digest = hashlib.blake2b(tensor_id.encode("utf-8"),
                                 digest_size=8).digest()
        return int.from_bytes(digest, "big") % self.shards


def load_manifest(store: ObjectStore, root: str) -> Optional[dict]:
    """The store manifest, or None for an unsharded (pre-existing) table."""
    try:
        return json.loads(store.get(manifest_key(root)))
    except ObjectNotFoundError:
        return None


def load_or_init_manifest(store: ObjectStore, root: str,
                          shards: Optional[int],
                          retention: Optional[dict] = None,
                          compression: Optional[str] = None) -> dict:
    """Resolve the store's shard layout, creating the manifest if needed.

    ``shards=None`` means "whatever the store already is" (1 when nothing
    exists yet). An explicit ``shards`` that contradicts an existing
    manifest is a hard error — N is immutable for the life of the store.

    ``retention`` (e.g. ``{"keep_versions": 3, "ttl_s": None}``) and
    ``compression`` (a chunk-blob codec spec like ``"zlib+shuffle"``) are
    recorded at create time so every client — including the
    ``repro.launch.gc`` maintenance CLI — agrees on the store's default
    vacuum policy and codec without out-of-band configuration.

    Unsharded stores normally write **no manifest** (byte-compat with
    pre-sharding tables) and keep their defaults client-side; creating a
    *fresh* unsharded store with an explicit ``compression`` is the one
    exception — the default is worth recording, and an extra
    ``_store_manifest.json`` beside a table changes no table bytes. An
    existing manifest is never rewritten: ctor arguments that differ from
    it act as client-side overrides, opening a store stays read-only.
    """
    existing = load_manifest(store, root)
    if existing is not None:
        found = int(existing["shards"])
        if shards is not None and int(shards) != found:
            raise ValueError(
                f"store at {root!r} has {found} shards; cannot open with "
                f"shards={shards} (shard count is fixed at create time)")
        return existing
    root = root.rstrip("/")
    if shards is None or int(shards) == 1:
        manifest = {"shards": 1, "router": ROUTER_ALGO,
                    "format": MANIFEST_FORMAT}
        if compression is None or compression == "none":
            # unsharded layout: table at <root>, no manifest written —
            # byte-compatible with pre-sharding tables
            return manifest
        if next(iter(store.list(f"{root}/_delta_log/")), None) is not None:
            # opening an existing table must not mutate it: the ctor's
            # compression acts as a client-side default only
            return manifest
        manifest["compression"] = compression
        if retention is not None:
            manifest["retention"] = dict(retention)
        return _put_manifest(store, root, manifest,
                             shards=1, retention=retention,
                             compression=compression)
    # creating a sharded store where an unsharded table already lives would
    # shadow its data forever (reads would resolve to empty shard tables)
    if next(iter(store.list(f"{root}/_delta_log/")), None) is not None:
        raise ValueError(
            f"an unsharded table already exists at {root!r}; cannot create "
            f"a {shards}-shard store over it (shard count is fixed at "
            f"create time)")
    manifest = {"shards": int(shards), "router": ROUTER_ALGO,
                "format": MANIFEST_FORMAT}
    if retention is not None:
        manifest["retention"] = dict(retention)
    if compression is not None and compression != "none":
        manifest["compression"] = compression
    return _put_manifest(store, root, manifest, shards=shards,
                         retention=retention, compression=compression)


def _put_manifest(store: ObjectStore, root: str, manifest: dict, *,
                  shards: Optional[int], retention: Optional[dict],
                  compression: Optional[str]) -> dict:
    """Create-once manifest write; a lost race defers to the winner."""
    body = json.dumps(manifest, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    try:
        store.put(manifest_key(root), body, if_absent=True)
    except PutIfAbsentError:
        # lost the create race: the winner's manifest is authoritative
        return load_or_init_manifest(store, root, shards,
                                     retention=retention,
                                     compression=compression)
    return manifest


def resolve_version_vector(shards: int,
                           version: Union[None, int, Sequence[int]],
                           ) -> Tuple[Optional[int], ...]:
    """Normalize a user-facing ``version=`` argument to one entry per shard.

    ``None`` entries mean "latest" for that shard. A bare int is accepted
    only on 1-shard stores (the pre-sharding API); sharded stores must pin
    a full vector — a single int is ambiguous across independent logs.
    """
    if version is None:
        return (None,) * shards
    if isinstance(version, (int,)) and not isinstance(version, bool):
        if shards != 1:
            raise TypeError(
                f"sharded store needs a {shards}-entry version vector, "
                f"got bare int {version}")
        return (int(version),)
    vv = tuple(None if v is None else int(v) for v in version)
    if len(vv) != shards:
        raise ValueError(
            f"version vector has {len(vv)} entries for {shards} shards")
    return vv
