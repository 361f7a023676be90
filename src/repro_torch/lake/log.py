"""Delta-style transaction log over an object store.

Faithful to the Delta Lake protocol shape (Armbrust et al., VLDB'20) at the
scale this framework needs:

* a table is a directory; its state is the ordered list of JSON commit files
  ``_delta_log/<version>.json``; each commit holds actions
  (``metaData`` / ``add`` / ``remove`` / ``commitInfo``), one JSON per line;
* a commit is atomic: put-if-absent of the next version file. Losers of the
  race retry on top of the new snapshot (optimistic concurrency). A writer
  that crashes after uploading data files but before the commit leaves no
  visible change — this is the checkpoint/restart safety story;
* every N commits a checkpoint file snapshots the live file list so readers
  replay O(N) recent commits, not the whole history;
* time travel = replay to an explicit version.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

from .object_store import ObjectStore, ObjectNotFoundError, PutIfAbsentError

CHECKPOINT_INTERVAL = 10

# spilled catalog indexes live beside (not inside) the delta log: one JSON
# per spilled version, deterministic content, written after the commit —
# see repro_torch.core.catalog.build_catalog_index
CATALOG_INDEX_DIR = "_catalog"


def _log_key(table: str, version: int) -> str:
    return f"{table}/_delta_log/{version:020d}.json"


def catalog_index_key(table: str, version: int) -> str:
    """Object key of the spilled catalog index for ``version``."""
    return f"{table}/{CATALOG_INDEX_DIR}/{version:020d}.index.json"


def catalog_index_version(table: str, key: str) -> Optional[int]:
    """Inverse of :func:`catalog_index_key`; None for foreign keys."""
    prefix = f"{table}/{CATALOG_INDEX_DIR}/"
    if not (key.startswith(prefix) and key.endswith(".index.json")):
        return None
    try:
        return int(key[len(prefix):-len(".index.json")])
    except ValueError:
        return None


def _ckpt_key(table: str, version: int) -> str:
    return f"{table}/_delta_log/{version:020d}.checkpoint.json"


def _last_ckpt_key(table: str) -> str:
    return f"{table}/_delta_log/_last_checkpoint"


@dataclass
class Snapshot:
    """Materialized table state at one version."""

    version: int
    metadata: Dict[str, Any]
    files: Dict[str, Dict[str, Any]]  # path -> add action payload

    def add_actions(self) -> List[Dict[str, Any]]:
        """Live add-actions (with ``path`` folded back in), path-sorted —
        the deterministic order every scan/catalog walk relies on."""
        return [dict(a, path=p) for p, a in sorted(self.files.items())]


class CommitConflict(Exception):
    """A fenced commit lost to a concurrent writer (or retries ran out).

    ``expected``/``found`` carry the version fence that failed so callers
    implementing rebase loops (e.g. ``WriteBatch``) can re-snapshot from
    ``found`` instead of re-probing the log.
    """

    def __init__(self, msg: str, *, expected: Optional[int] = None,
                 found: Optional[int] = None):
        super().__init__(msg)
        self.expected = expected
        self.found = found


class DeltaLog:
    """One table's ordered commit history (the ``_delta_log/`` tree)."""

    def __init__(self, store: ObjectStore, table_path: str):
        self.store = store
        self.table = table_path.rstrip("/")
        # log files are immutable: a version's snapshot never changes, so
        # replayed snapshots are cached for the life of the client
        self._snap_cache: Dict[int, Snapshot] = {}
        # highest version known to exist (None = never probed). Commit files
        # are append-only, so a cached floor only ever moves forward.
        self._latest: Optional[int] = None
        # commit timestamps are immutable once written — cached for the
        # TTL half of vacuum's retention policy
        self._commit_ts: Dict[int, float] = {}

    # -- write side ---------------------------------------------------------

    def commit(self, actions: List[Dict[str, Any]], *, expected_version: Optional[int] = None,
               op: str = "WRITE", max_retries: int = 20) -> int:
        """Atomically append one commit; returns the committed version.

        With ``expected_version`` the commit only succeeds against exactly
        that snapshot (serializable writers, e.g. checkpoint step fencing);
        otherwise losers rebase and retry (append-only commits commute).
        """
        attempt = 0
        while True:
            latest = self.latest_version()
            if expected_version is not None and latest != expected_version:
                raise CommitConflict(
                    f"expected v{expected_version}, found v{latest}",
                    expected=expected_version, found=latest)
            version = latest + 1
            payload = "\n".join(
                json.dumps(a, separators=(",", ":"))
                for a in actions + [{"commitInfo": {"op": op, "ts": time.time()}}])
            try:
                self.store.put(_log_key(self.table, version),
                               payload.encode("utf-8"), if_absent=True)
            except PutIfAbsentError:
                # somebody else owns this version; remember it so the retry
                # probes forward instead of re-listing the whole log dir
                self._latest = max(self._latest or -1, version)
                attempt += 1
                if expected_version is not None or attempt > max_retries:
                    raise CommitConflict(f"lost commit race at v{version}",
                                         expected=expected_version,
                                         found=version)
                continue
            self._latest = max(self._latest or -1, version)
            if version % CHECKPOINT_INTERVAL == 0:
                self._write_checkpoint(version)
            return version

    def _write_checkpoint(self, version: int) -> None:
        snap = self.snapshot(version)
        body = json.dumps({
            "version": version,
            "metadata": snap.metadata,
            "files": snap.files,
        }, separators=(",", ":")).encode("utf-8")
        self.store.put(_ckpt_key(self.table, version), body)
        self.store.put(_last_ckpt_key(self.table),
                       json.dumps({"version": version}).encode("utf-8"))

    # -- read side ----------------------------------------------------------

    def latest_version(self) -> int:
        """-1 when the table does not exist yet.

        A full ``_delta_log/`` prefix list happens at most once per client
        (cold start on a table with no checkpoint). Afterwards the cached
        latest — raised by ``_last_checkpoint`` when available — is extended
        by probing ``head(v+1)`` forward, which is O(new commits) instead of
        O(log length) and issues zero list requests on hot commit paths.
        """
        floor = self._latest
        if floor is None:
            floor = self._checkpoint_version()
        if floor is None:
            floor = self._list_latest()
        v = floor
        while self.store.exists(_log_key(self.table, v + 1)):
            v += 1
        self._latest = v
        return v

    def refresh_latest(self) -> int:
        """Authoritative re-resolution of the latest version.

        The probe-forward cache in :meth:`latest_version` trusts a single
        ``head(v + 1)`` miss to mean "no newer commit" — under an external
        writer on an eventually-consistent store (HEAD-after-PUT lag), that
        probe can miss a commit that a full listing already shows. This
        drops the cached floor and re-resolves from the log listing plus
        the checkpoint pointer, then probes forward from whichever is
        higher. Called by :meth:`snapshot` before declaring a version
        "future" (invalidate-on-miss); operators can call it directly to
        force a freshness check.
        """
        ckpt = self._checkpoint_version()
        v = max(self._list_latest(), ckpt if ckpt is not None else -1)
        while self.store.exists(_log_key(self.table, v + 1)):
            v += 1
        # the cached floor only ever moves forward: a stale LIST on the
        # same eventually-consistent store must not un-learn a version
        # this client has already observed
        self._latest = max(self._latest or -1, v)
        return self._latest

    def _checkpoint_version(self) -> Optional[int]:
        """Version recorded in ``_last_checkpoint`` (a known-to-exist floor)."""
        try:
            ptr = json.loads(self.store.get(_last_ckpt_key(self.table)))
            return int(ptr["version"])
        except (ObjectNotFoundError, KeyError, ValueError, json.JSONDecodeError):
            return None

    def _list_latest(self) -> int:
        latest = -1
        prefix = f"{self.table}/_delta_log/"
        for key in self.store.list(prefix):
            name = key[len(prefix):]
            if name.endswith(".json") and not name.endswith(".checkpoint.json"):
                try:
                    latest = max(latest, int(name[:-5]))
                except ValueError:
                    continue
        return latest

    def _checkpoint_at_or_before(self, version: int) -> Optional[Dict[str, Any]]:
        try:
            ptr = json.loads(self.store.get(_last_ckpt_key(self.table)))
            v = ptr["version"]
            if v <= version:
                return json.loads(self.store.get(_ckpt_key(self.table, v)))
        except (ObjectNotFoundError, KeyError, json.JSONDecodeError):
            pass
        # fall back: scan for any usable checkpoint
        best = None
        prefix = f"{self.table}/_delta_log/"
        for key in self.store.list(prefix):
            if key.endswith(".checkpoint.json"):
                v = int(key[len(prefix):-len(".checkpoint.json")])
                if v <= version and (best is None or v > best):
                    best = v
        if best is not None:
            return json.loads(self.store.get(_ckpt_key(self.table, best)))
        return None

    def cached_snapshot(self, version: int) -> Optional[Snapshot]:
        """Peek the snapshot cache — no I/O, None when never replayed."""
        return self._snap_cache.get(version)

    def commit_ts(self, version: int) -> Optional[float]:
        """The ``commitInfo.ts`` of one version (None if unreadable).

        One log-file get per uncached version; timestamps are immutable so
        the answer is cached for the life of the client. Used by vacuum's
        TTL retention ("keep every version younger than N seconds").
        """
        ts = self._commit_ts.get(version)
        if ts is not None:
            return ts
        try:
            body = self.store.get(_log_key(self.table, version)).decode("utf-8")
        except ObjectNotFoundError:
            return None
        for line in body.splitlines():
            if not line:
                continue
            action = json.loads(line)
            info = action.get("commitInfo")
            if info and "ts" in info:
                self._commit_ts[version] = float(info["ts"])
                return self._commit_ts[version]
        return None

    def snapshot(self, version: Optional[int] = None) -> Snapshot:
        """Materialize table state at ``version`` (latest if None).

        Replays checkpoint + trailing commits once, then serves from the
        immutable snapshot cache. Raises :class:`ObjectNotFoundError` for
        a missing table and ``ValueError`` for future versions."""
        if version is not None:
            # pinned reads on a cached snapshot are fully local: log files
            # are immutable, so no freshness probe is needed
            cached = self._snap_cache.get(version)
            if cached is not None:
                return cached
        latest = self.latest_version()
        if version is not None and version > latest:
            # invalidate-on-miss: an external writer may have landed a
            # commit the forward probe missed (see refresh_latest) — only
            # re-list before concluding the caller asked for the future
            latest = self.refresh_latest()
        if latest < 0:
            raise ObjectNotFoundError(f"no delta table at {self.table}")
        version = latest if version is None else version
        if version > latest:
            raise ValueError(f"time travel to v{version} but latest is v{latest}")
        cached = self._snap_cache.get(version)
        if cached is not None:
            return cached

        metadata: Dict[str, Any] = {}
        files: Dict[str, Dict[str, Any]] = {}
        start = 0
        ckpt = self._checkpoint_at_or_before(version)
        if ckpt:
            metadata = ckpt["metadata"]
            files = dict(ckpt["files"])
            start = ckpt["version"] + 1

        for v in range(start, version + 1):
            try:
                body = self.store.get(_log_key(self.table, v)).decode("utf-8")
            except ObjectNotFoundError:
                continue  # gaps cannot happen via commit(); tolerate anyway
            for line in body.splitlines():
                if not line:
                    continue
                action = json.loads(line)
                if "metaData" in action:
                    metadata = action["metaData"]
                elif "add" in action:
                    a = dict(action["add"])
                    files[a.pop("path")] = a
                elif "remove" in action:
                    files.pop(action["remove"]["path"], None)
        snap = Snapshot(version=version, metadata=metadata, files=files)
        self._snap_cache[version] = snap
        if len(self._snap_cache) > 64:
            self._snap_cache.pop(next(iter(self._snap_cache)))
        return snap

    def history(self) -> Iterator[Dict[str, Any]]:
        """Yield each version's ``commitInfo`` (op, timestamp, version)."""
        for v in range(self.latest_version() + 1):
            try:
                body = self.store.get(_log_key(self.table, v)).decode("utf-8")
            except ObjectNotFoundError:
                continue
            for line in body.splitlines():
                action = json.loads(line)
                if "commitInfo" in action:
                    yield dict(action["commitInfo"], version=v)
