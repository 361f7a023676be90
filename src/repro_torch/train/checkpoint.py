"""Distributed checkpointing on the Delta Tensor store, the port of
``repro.train.checkpoint``.

Every train-state leaf is stored as FTSF chunk rows in one delta table,
named by its path in the state (``params/embed``, ``opt/m/embed``,
``opt/count``, ``step``: :mod:`repro_torch.tree`, as the reference's
``_path_str``); a checkpoint step is ONE atomic
:class:`~repro_torch.core.batch.WriteBatch` commit (two-phase: upload all
part files, then commit), so a crash mid-write leaves the previous
checkpoint intact. A restore pulls the whole leaf tree through ONE catalog
snapshot and ONE merged :meth:`~repro_torch.core.catalog.Catalog.read_many`
fetch plan straight onto the device: on the card, each leaf's chunk rows
are staged in arrival order and reordered by the ``block_gather`` kernel.
The tables are the reference's, byte for byte: a checkpoint written by
either package restores in the other.

* **incremental**: per-leaf content hashes; unchanged leaves are not
  re-uploaded, the manifest re-points to the prior version's chunks;
* **elastic restore**: ``restore(..., shard_slices=...)`` reads exactly the
  rows of a slice of a leaf;
* **async**: ``save_async`` snapshots the state to host memory before it
  returns and uploads on a background thread; ``wait()`` joins;
* **time travel / retention**: ``restore(step=...)`` replays the manifest
  for that step; ``keep_checkpoints=K`` leases the last K saved versions
  so a ``store.vacuum()`` cannot break a restorable checkpoint;
  :meth:`prune` and :meth:`gc` delete checkpoints beyond the last K
  (respecting incremental chunk reuse) and vacuum the freed bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.encodings.base import dtype_name
from ..core.leases import Lease
from ..core.store import DeltaTensorStore
from ..lake import ObjectStore
from ..tree import leaves, rebuild, to_numpy


def _leaf_hash(x: np.ndarray) -> str:
    # the dtype's name, not numpy's: bfloat16 staged without ml_dtypes is
    # uint16 to numpy, and must hash as the bfloat16 it is
    h = hashlib.blake2b(digest_size=12)
    h.update(dtype_name(x.dtype).encode())
    h.update(str(x.shape).encode())
    h.update(np.ascontiguousarray(x).view(np.uint8))  # the bytes, no copy
    return h.hexdigest()


def _snapshot(x: Any) -> np.ndarray:
    """A host copy of leaf ``x`` that later in-place updates do not reach
    (a host tensor's numpy view would share its memory)."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return to_numpy(x)      # the device-to-host copy is the snapshot
    return np.array(to_numpy(x), copy=True)


class DeltaCheckpointer:
    """Checkpoints of a train state in a Delta Tensor store at ``root``.

    ``device`` is where :meth:`restore` lands the leaves by default (the
    store's device: ``"cuda"`` unless the caller passes ``"cpu"``).
    """

    def __init__(self, object_store: ObjectStore, root: str = "checkpoints", *,
                 chunk_dims: Optional[int] = None,
                 shards: Optional[int] = None,
                 keep_checkpoints: Optional[int] = None,
                 device: Any = "cuda"):
        # shards=N: leaves hash across N commit domains; manifest rows stay
        # on shard 0, so `steps`/`restore` scan one table whatever N is
        self.store = DeltaTensorStore(object_store, root, shards=shards,
                                      device=device)
        self.chunk_dims = chunk_dims
        self.keep_checkpoints = keep_checkpoints
        self._ckpt_leases: List[Tuple[int, Lease]] = []  # (step, lease), oldest first
        self._last_hashes: Dict[str, Tuple[str, str]] = {}  # leaf -> (hash, tid)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def _upload(self, step: int, host: List[Tuple[str, np.ndarray]]) -> None:
        manifest: Dict[str, str] = {}
        new_hashes: Dict[str, Tuple[str, str]] = {}
        # one WriteBatch = the whole checkpoint; a byte-identical chunk of a
        # changed leaf still dedups through the store's chunk index
        # blake2b releases the GIL: the leaves hash at once
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            digests = list(pool.map(_leaf_hash, [arr for _, arr in host]))
        with self.store.batch(op=f"CHECKPOINT step={step}") as batch:
            for (name, arr), digest in zip(host, digests):
                prev = self._last_hashes.get(name)
                if prev is not None and prev[0] == digest:
                    manifest[name] = prev[1]       # unchanged: reuse chunks
                    continue
                tid = f"{name}@{step}"
                batch.put(arr, tensor_id=tid, layout="ftsf",
                          chunk_dims=self.chunk_dims)
                manifest[name] = tid
                new_hashes[name] = (digest, tid)
            batch.add_rows(
                {"step": np.asarray([step], np.int64),
                 "manifest": [json.dumps(manifest, sort_keys=True).encode()]},
                partition_values={"kind": "ckpt_manifest"})
        # only a committed checkpoint may update the incremental-skip state;
        # a failed batch must not make the next save skip an upload
        self._last_hashes.update(new_hashes)
        if self.keep_checkpoints is not None:
            self._ckpt_leases.append((step, self.store.lease(batch.version)))
            while len(self._ckpt_leases) > self.keep_checkpoints:
                _, old = self._ckpt_leases.pop(0)
                old.release()

    def save(self, step: int, state: Any) -> None:
        """Commit ``state`` (a tree of tensors) as checkpoint ``step``."""
        self._upload(step, [(n, to_numpy(x)) for n, x in leaves(state)])

    def save_async(self, step: int, state: Any) -> None:
        """Copy ``state`` to host memory now, then commit it on a background
        thread (the next train steps may update the tensors in place);
        :meth:`wait` joins and raises the upload's error."""
        self.wait()
        host = [(n, _snapshot(x)) for n, x in leaves(state)]

        def run():
            try:
                self._upload(step, host)
            except BaseException as e:  # surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join a pending :meth:`save_async`; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore --------------------------------------------------------------

    def steps(self) -> List[int]:
        """Every committed checkpoint step, ascending."""
        out = []
        for batch in self.store.table.scan(
                partition_filters={"kind": "ckpt_manifest"}):
            out.extend(int(s) for s in np.asarray(batch["step"]))
        return sorted(set(out))

    def _pinned_version(self, step: Optional[int]):
        """The version vector our retention lease pinned for ``step``
        (None when we hold no live lease for it)."""
        for s, lease in self._ckpt_leases:
            if s == step and not lease.released:
                return lease.version_vector
        return None

    def _manifest(self, step: Optional[int], *,
                  version: Optional[int] = None) -> Tuple[int, Dict[str, str]]:
        best: Tuple[int, Dict[str, str]] = (-1, {})
        for batch in self.store.table.scan(
                partition_filters={"kind": "ckpt_manifest"}, version=version):
            for s, blob in zip(np.asarray(batch["step"]), batch["manifest"]):
                s = int(s)
                if (step is None and s > best[0]) or (step is not None and s == step):
                    best = (s, json.loads(bytes(blob)))
        if best[0] < 0:
            raise KeyError(f"no checkpoint found (requested step={step})")
        return best

    def restore(self, template: Any, *, step: Optional[int] = None,
                shard_slices: Optional[Dict[str, Sequence]] = None,
                device: Any = None) -> Tuple[int, Any]:
        """``(step found, state)``: checkpoint ``step`` (the latest when
        None) as a tree shaped and typed like ``template`` (a tree of
        tensors; meta tensors will do), its leaves on ``device`` (the
        store's by default).

        ``shard_slices`` ({leaf path: slice spec}) reads only those rows of
        a leaf (elastic restore on a new layout). A step we hold a
        retention lease for restores against its pinned version vector, so
        it survives another actor's prune and vacuum.
        """
        pinned = self._pinned_version(step) if step is not None else None
        step_found, manifest = self._manifest(
            step, version=None if pinned is None else pinned[0])
        flat = leaves(template)
        # ONE catalog snapshot and ONE merged fetch plan: chunk files shared
        # across leaves (incremental saves) fetch once
        catalog = self.store.catalog(pinned)
        requests = [(manifest[name],
                     shard_slices.get(name) if shard_slices else None)
                    for name, _ in flat]
        tensors = catalog.read_many(requests, device=device or self.store.device)
        out = [t if t.dtype == leaf.dtype else t.to(leaf.dtype)
               for t, (_, leaf) in zip(tensors, flat)]
        return step_found, rebuild(template, iter(out))

    def restore_available(self) -> bool:
        """Whether any checkpoint is committed."""
        try:
            self._manifest(None)
            return True
        except KeyError:
            return False

    # -- retention / maintenance ----------------------------------------------

    def _manifest_files(self) -> List[Tuple[str, List[int], Dict[int, Dict[str, str]]]]:
        """Each manifest data file with the steps it holds and their
        manifests. One file per save normally; compact can merge several."""
        table = self.store.table
        adds = table.plan_scan(partition_filters={"kind": "ckpt_manifest"})
        out = []
        for add, batch in zip(adds, table.fetch_adds(adds)):
            steps = [int(s) for s in np.asarray(batch["step"])]
            manifests = {int(s): json.loads(bytes(blob))
                         for s, blob in zip(np.asarray(batch["step"]),
                                            batch["manifest"])}
            out.append((add["path"], steps, manifests))
        return out

    def prune(self, keep: Optional[int] = None) -> List[int]:
        """Delete checkpoints beyond the newest ``keep`` steps; returns the
        pruned steps.

        Tensors still referenced by a kept step's manifest are never
        deleted. Manifest files whose every step is pruned leave the log;
        files mixing kept and pruned steps (after a compact) stay whole.
        Leases held for pruned steps are released so vacuum can reclaim
        the bytes.
        """
        keep = self.keep_checkpoints if keep is None else int(keep)
        if keep is None or keep < 1:
            raise ValueError("prune needs keep >= 1 (or keep_checkpoints set)")
        files = self._manifest_files()
        all_steps = sorted({s for _, steps, _ in files for s in steps})
        if len(all_steps) <= keep:
            return []
        kept = set(all_steps[-keep:])
        referenced = {tid for _, _, m in files for s, man in m.items()
                      if s in kept for tid in man.values()}
        doomed_tids = sorted({tid for _, _, m in files for s, man in m.items()
                              if s not in kept for tid in man.values()}
                             - referenced)
        if doomed_tids:
            with self.store.batch(op=f"PRUNE CHECKPOINTS keep={keep}") as b:
                for tid in doomed_tids:
                    b.delete(tid, missing_ok=True)
        doomed_paths = [p for p, steps, _ in files
                        if steps and all(s not in kept for s in steps)]
        if doomed_paths:
            self.store.table.commit_adds([], removes=doomed_paths,
                                         op="PRUNE MANIFESTS")
        # re-pin surviving leases to the post-prune latest: the old pins
        # still include the pruned steps' files and would keep vacuum from
        # reclaiming them
        survivors = []
        for s, lease in self._ckpt_leases:
            if s in kept:
                survivors.append((s, self.store.lease()))
            lease.release()
        self._ckpt_leases = survivors
        return [s for s in all_steps if s not in kept]

    def gc(self, keep: Optional[int] = None, *,
           dry_run: bool = False) -> Dict[str, Any]:
        """Prune + compact + vacuum the checkpoint store in one call. With
        ``dry_run`` nothing is committed or deleted; the vacuum half reports
        what a real run would reclaim under the current leases."""
        keep = self.keep_checkpoints if keep is None else keep
        pruned: List[int] = []
        compact = []
        if not dry_run:
            if keep is not None:
                pruned = self.prune(keep)
            compact = self.store.compact()
        vacuum = self.store.vacuum(dry_run=dry_run)
        return {
            "pruned_steps": pruned,
            "files_compacted": sum(r.files_compacted for r in compact),
            "files_deleted": sum(r.files_deleted for r in vacuum),
            "bytes_reclaimed": sum(r.bytes_reclaimed for r in vacuum),
            "compact": compact,
            "vacuum": vacuum,
        }
