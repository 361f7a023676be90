"""WriteBatch — stage many tensor writes/deletes, land atomic commits.

Replaces the ad-hoc two-phase code that each writer (checkpointer, serve
weight saver) used to hand-roll over ``put_deferred`` + ``commit_adds``:

    with store.batch(op="CHECKPOINT step=7") as b:
        for name, arr in leaves:
            b.put(arr, tensor_id=f"{name}@7", layout="ftsf")
    print(b.version)          # the committed version (vector if sharded)

Part files are uploaded as they are staged (invisible until the commit);
``__exit__`` commits everything — puts, overwrites, deletes, raw rows — as
one delta-log action list **per shard**, so readers observe either all of a
shard's slice of the batch or none of it. On an unsharded store that is
exactly one atomic commit, as before. An exception inside the ``with``
block abandons the batch: uploaded files stay invisible to every snapshot
(vacuum reclaims them) and **no header is cached**, which is the fix for
the old put_deferred staleness bug where a failed batched commit left a
poisoned header cache.

**Commit-retry/rebase** (the ROADMAP follow-on): every per-shard commit is
fenced with ``expected_version`` = the batch's base snapshot for that
shard. When a concurrent writer lands first, the fence raises
:class:`~repro_torch.lake.log.CommitConflict`; the batch then *rebases* — it
re-snapshots the conflicted shard, re-validates that no tensor staged here
was concurrently modified (same staged files present/absent as at the
base), and re-commits against the new version — up to ``commit_retries``
times. Disjoint-tensor writers therefore all succeed; a genuine
same-tensor overlap is non-rebasable and raises ``CommitConflict``
immediately (retrying cannot make two overwrites of one tensor commute).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional, Tuple, Union, TYPE_CHECKING

from ..lake.log import CommitConflict, Snapshot
from ..lake.table import DeltaTable

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .store import DeltaTensorStore

DEFAULT_COMMIT_RETRIES = 10


class BatchClosedError(RuntimeError):
    """Raised when staging into an already committed/abandoned batch."""


def _tensor_paths(snapshot: Snapshot) -> Dict[str, List[str]]:
    """tid -> sorted live file paths in one shard snapshot."""
    out: Dict[str, List[str]] = {}
    for add in snapshot.add_actions():
        tid = (add.get("partitionValues") or {}).get("tensor")
        if tid is not None:
            out.setdefault(tid, []).append(add["path"])
    return {tid: sorted(paths) for tid, paths in out.items()}


class WriteBatch:
    """Stages puts/deletes against per-shard base snapshots; commits per shard.

    A shard's base snapshot is pinned the first time the batch touches that
    shard: every existence/overwrite/delete lookup resolves against it, so
    what a batch removes does not shift under a concurrent writer. Shards
    the batch never touches are never probed — on a sharded store a
    single-tensor put costs one shard's snapshot, not N. At commit time
    each touched shard lands one atomic commit fenced against its base,
    with the bounded rebase loop above resolving append-only races.

    Cross-shard note: per-shard commits are each atomic, but a batch that
    spans several shards is not a single cross-shard transaction — a reader
    sampling mid-commit can see some shards' slices landed and others not.
    Pin a version vector (``store.catalog()``) for a consistent view.
    """

    def __init__(self, store: "DeltaTensorStore", *, op: str = "WRITE BATCH",
                 commit_retries: Optional[int] = None):
        self._store = store
        self.op = op
        self.commit_retries = (DEFAULT_COMMIT_RETRIES if commit_retries is None
                               else max(0, int(commit_retries)))
        # staged operations, in order: each is a dict with
        #   kind: "put" | "delete" | "rows"
        #   shard: destination shard index
        #   tid:   tensor id ("put"/"delete" only; None for raw rows)
        #   adds:  add-actions uploaded for this op
        #   removes: file paths this op removes (resolved at the base)
        self._ops: List[Dict[str, Any]] = []
        # per-shard upload guards: staged part files register as in-flight
        # so a concurrent vacuum cannot delete them as orphans before the
        # commit lands; closed on commit/abandon (see UploadGuard)
        self._guards: Dict[int, Any] = {}
        # header seeds applied to the store's by-path cache ONLY on a
        # successful commit (never for an abandoned batch)
        self._header_seeds: List[tuple] = []
        self._staged_tids: List[str] = []
        # per-shard base pins: shard -> (base version, tid -> live paths)
        self._base_versions: Dict[int, int] = {}
        self._base_paths: Dict[int, Dict[str, List[str]]] = {}
        self._closed = False
        # committed version: int on 1-shard stores, version vector tuple on
        # sharded stores (resolved lazily); detail in `shard_versions`
        self._version: Union[None, int, Tuple[int, ...]] = None
        self.shard_versions: Dict[int, int] = {}  # shard -> committed version
        self.conflicts = 0  # CommitConflicts this batch hit (and rebased)

    # -- staging ---------------------------------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise BatchClosedError("WriteBatch already committed or abandoned")

    def _guard(self, shard: int):
        g = self._guards.get(shard)
        if g is None:
            g = self._guards[shard] = self._store.tables[shard].guard_uploads()
        return g

    def _close_guards(self) -> None:
        for g in self._guards.values():
            g.close()

    def put(self, tensor: Any, *, layout: str = "auto",
            tensor_id: Optional[str] = None, overwrite: bool = False,
            target_file_bytes: Optional[int] = None,
            compression: Optional[str] = None, **codec_params) -> str:
        """Stage one tensor; returns its id. Files upload now, commit later.

        ``compression`` overrides the store's default chunk-blob codec for
        this tensor (a spec like ``"zlib+shuffle"``; ``None`` = default).
        Raises ``ValueError`` on duplicate staging or an existing id
        without ``overwrite`` — checked before any byte is uploaded.
        """
        self._check_open()
        layout, tid = self._store._resolve_tid(tensor, layout, tensor_id)
        # all checks run BEFORE any byte uploads: a rejected put must not
        # cost encode+upload bandwidth or leave orphaned invisible files
        if tid in self._staged_tids:
            raise ValueError(f"tensor {tid!r} staged twice in one batch")
        existing = self._existing_paths(tid)
        if existing and not overwrite:
            raise ValueError(
                f"tensor {tid!r} already exists (use overwrite=True)")
        shard, adds, header_seed = self._store._encode_and_upload(
            tensor, layout=layout, tensor_id=tid,
            target_file_bytes=target_file_bytes,
            guard=self._guard(self._store.router.shard_of(tid)),
            compression=compression,
            **codec_params)
        self._ops.append({"kind": "put", "shard": shard, "tid": tid,
                          "adds": adds, "removes": sorted(existing)})
        if header_seed is not None:
            self._header_seeds.append(header_seed)
        self._staged_tids.append(tid)
        return tid

    def put_variant(self, tensor: Any, *, base_tid: str,
                    tensor_id: Optional[str] = None, overwrite: bool = False,
                    target_file_bytes: Optional[int] = None,
                    compression: Optional[str] = None) -> str:
        """Stage ``tensor`` as a delta-encoded variant of ``base_tid``.

        Chunks identical to the base dedup into pure references via the
        chunk index; differing chunks upload as XOR deltas against the
        base's objects. The staged tensor is an ordinary tensor in every
        other way (same commit/rebase semantics as :meth:`put`). The
        default id is ``"<base_tid>~<hex>"``; pass ``tensor_id`` to
        choose one. Raises ``KeyError`` if ``base_tid`` does not exist.
        """
        self._check_open()
        tid = tensor_id if tensor_id is not None else \
            f"{base_tid}~{uuid.uuid4().hex[:8]}"
        if tid in self._staged_tids:
            raise ValueError(f"tensor {tid!r} staged twice in one batch")
        existing = self._existing_paths(tid)
        if existing and not overwrite:
            raise ValueError(
                f"tensor {tid!r} already exists (use overwrite=True)")
        shard, adds, header_seed = self._store._encode_and_upload_variant(
            tensor, base_tid=base_tid, tensor_id=tid,
            target_file_bytes=target_file_bytes, compression=compression,
            guard_for=self._guard)
        self._ops.append({"kind": "put", "shard": shard, "tid": tid,
                          "adds": adds, "removes": sorted(existing)})
        if header_seed is not None:
            self._header_seeds.append(header_seed)
        self._staged_tids.append(tid)
        return tid

    def delete(self, tid: str, *, missing_ok: bool = False) -> None:
        """Stage removal of every file of ``tid`` (header + chunks)."""
        self._check_open()
        paths = self._existing_paths(tid)
        if not paths and not missing_ok:
            raise KeyError(f"tensor {tid!r} not found")
        if paths:
            self._ops.append({"kind": "delete",
                              "shard": self._store.router.shard_of(tid),
                              "tid": tid, "adds": [],
                              "removes": sorted(paths)})

    def add_rows(self, columns: Dict[str, Any], *,
                 partition_values: Optional[Dict[str, str]] = None) -> None:
        """Stage one raw table file (e.g. a checkpoint manifest row).

        Raw rows have no tensor id, so they always land on shard 0 (the
        meta shard) and are pure adds — a conflict on them is always
        rebasable by re-committing as-is.
        """
        self._check_open()
        add = self._store.tables[0].append(
            columns, commit=False, partition_values=partition_values or {},
            guard=self._guard(0))
        self._ops.append({"kind": "rows", "shard": 0, "tid": None,
                          "adds": [add], "removes": []})

    def _pin_shard(self, shard: int) -> None:
        """Pin this shard's base snapshot on first touch (then reuse it)."""
        if shard not in self._base_versions:
            snap = self._store.tables[shard].snapshot()
            self._base_versions[shard] = snap.version
            self._base_paths[shard] = _tensor_paths(snap)

    def _existing_paths(self, tid: str) -> List[str]:
        shard = self._store.router.shard_of(tid)
        self._pin_shard(shard)
        return self._base_paths[shard].get(tid, [])

    # -- terminal states -------------------------------------------------------

    @property
    def staged(self) -> List[str]:
        """Tensor ids staged by :meth:`put` so far, in staging order."""
        return list(self._staged_tids)

    @property
    def version(self) -> Union[None, int, Tuple[int, ...]]:
        """Committed version: int (1-shard) or a version vector (sharded).

        On a sharded store the vector covers ALL shards — committed shards
        at their new versions, untouched shards probed lazily on first
        access (so batches that never read ``version`` never pay for it).
        The vector is a valid logical pin observed just after the commit.
        """
        if self._version is None and self._closed and self.shard_versions \
                and self._store.shards > 1:
            vv = list(self._store.version_vector())
            for s, v in self.shard_versions.items():
                vv[s] = max(vv[s], v)
            self._version = tuple(vv)
        return self._version

    def _rebase(self, table: DeltaTable, ops: List[Dict[str, Any]]) -> int:
        """Re-snapshot one conflicted shard and re-validate the staged ops.

        Rebasable = every tensor this batch touches is byte-identical to
        the base in the fresh snapshot (same live files for overwrites and
        deletes, still absent for fresh puts) — then the staged add/remove
        actions still mean the same thing and can simply re-commit on top.
        Anything else is a genuine same-tensor overlap: raise.
        """
        snap = table.snapshot()
        live = _tensor_paths(snap)
        for op in ops:
            tid = op["tid"]
            if tid is None:
                continue  # raw rows: pure adds, nothing to re-validate
            if live.get(tid, []) != op["removes"]:
                raise CommitConflict(
                    f"tensor {tid!r} was concurrently modified; batch "
                    f"cannot be rebased", found=snap.version)
        return snap.version

    def commit(self) -> Union[None, int, Tuple[int, ...]]:
        """Land every staged action, one fenced atomic commit per shard.

        Returns the committed version on 1-shard stores. On sharded stores
        it returns None — read ``batch.version`` (lazy) or
        ``batch.shard_versions`` (free) instead; resolving the full vector
        eagerly here would probe every shard log on every commit.
        """
        self._check_open()
        self._closed = True
        if not self._ops:
            self._version = self._store.version()
            return self._version
        try:
            return self._commit_shards()
        finally:
            # committed files are live in snapshots, failed ones are
            # vacuumable orphans — either way the in-flight guard is done
            self._close_guards()

    def _commit_shards(self) -> Union[None, int, Tuple[int, ...]]:
        per_shard: Dict[int, List[Dict[str, Any]]] = {}
        for op in self._ops:
            per_shard.setdefault(op["shard"], []).append(op)

        stats = self._store.commit_stats
        for shard in sorted(per_shard):
            ops = per_shard[shard]
            adds = [a for op in ops for a in op["adds"]]
            removes = [p for op in ops for p in op["removes"]]
            table = self._store.tables[shard]
            self._pin_shard(shard)       # rows-only shards pin here
            expected = self._base_versions[shard]
            attempts = 0
            while True:
                try:
                    v = table.commit_adds(adds, removes=removes, op=self.op,
                                          expected_version=expected)
                    stats["commits"] += 1
                    self.shard_versions[shard] = v
                    break
                except CommitConflict:
                    stats["conflicts"] += 1
                    self.conflicts += 1
                    attempts += 1
                    if attempts > self.commit_retries:
                        raise
                    # rebase: raises CommitConflict itself on real overlap
                    expected = self._rebase(table, ops)
                    stats["retries"] += 1
            # spill-to-index hook: once a shard snapshot crosses the
            # store's threshold, write the catalog index beside the log so
            # cold readers skip the O(files) walk (cheap-guarded no-op on
            # small shards)
            self._store._maybe_spill(shard, v, adds_hint=len(adds))

        if self._store.shards == 1:
            self._version = self.shard_versions[0]
        # sharded: the full vector resolves lazily in the `version` property
        # headers become cacheable only now: the data is visible and the
        # header file path is immutable, so this can never go stale
        for path, cols in self._header_seeds:
            self._store._seed_header(path, cols)
        return self._version

    def abandon(self) -> None:
        """Drop the batch; uploaded part files remain invisible (and,
        with the upload guards closed, vacuumable as orphans)."""
        self._closed = True
        self._close_guards()

    def __enter__(self) -> "WriteBatch":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abandon()
        elif not self._closed:
            self.commit()
