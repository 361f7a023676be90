"""ModelRepo: snapshot-pinned handle over one prefix of serving weights.

The port of ``repro.serve.repo``, over the port's store:

* ``store.models(prefix)`` returns a repo **pinned to one catalog
  snapshot** and holding a lease on it, so concurrent re-saves and vacuum
  cannot change (or delete) what this handle reads. ``save`` advances the
  pin to the just-committed generation; ``refresh()`` re-pins at latest.
* ``repo.save(params)`` persists a param tree (torch tensors on any
  device, or numpy arrays): one FTSF tensor per leaf under
  ``<prefix>/<leaf name>``, ONE atomic commit, the old generation replaced
  in the same commit. Leaf names come from :mod:`repro_torch.tree`, as the
  reference names them, so either package loads what the other saved.
* ``repo.load(template, device=...)`` reads the whole tree through ONE
  merged :meth:`~repro_torch.core.catalog.Catalog.read_many` plan on the
  device: FTSF chunk rows are staged in arrival order and reordered on the
  card by ``block_gather`` (:class:`~repro_torch.lake.device.ChunkAssembler`),
  and compressed frames go through the CUDA unshuffle hook. The reference
  returns host numpy and lets ``jit`` place it; the bytes are the same.
* ``repo.open_variant(name)`` returns a repo for ``<prefix>~<name>`` whose
  ``save`` stores each leaf as an XOR delta of this repo's leaf.
"""

from __future__ import annotations

import weakref
from typing import (TYPE_CHECKING, Any, Dict, List, Optional, Sequence,
                    Tuple)

from ..core.catalog import Catalog
from ..lake.io import ReadExecutor
from ..lake.log import ObjectNotFoundError
from ..tree import leaves, rebuild, to_numpy

if TYPE_CHECKING:  # pragma: no cover - import cycle is typing-only
    from ..core.store import DeltaTensorStore, VersionArg


class ModelRepo:
    """Snapshot-pinned, lease-holding handle to one model's weight tree.

    Construct via ``store.models(prefix)``. The repo pins the store's
    catalog at construction (latest, or an explicit ``version=``) and
    leases that version vector until ``close()`` / context-manager exit /
    garbage collection. A repo over a prefix with no saved weights is valid
    (``exists()`` is False); the first ``save`` pins it.
    """

    def __init__(self, store: "DeltaTensorStore", prefix: str, *,
                 version: "VersionArg" = None,
                 base: Optional["ModelRepo"] = None):
        if not prefix:
            raise ValueError("model prefix must be a non-empty string")
        self.store = store
        self.prefix = prefix
        self._base = base
        self._catalog: Optional[Catalog] = None
        self._finalizer = weakref.finalize(self, lambda: None)
        self._pin(version)

    # -- lifecycle -------------------------------------------------------------

    def _pin(self, version: "VersionArg") -> None:
        """(Re)pin the repo's catalog snapshot, swapping the held lease."""
        try:
            catalog = self.store.catalog(version)
        except ObjectNotFoundError:
            if version is not None:
                raise
            catalog = None  # store has no table yet; first save pins
        old = self._finalizer
        if catalog is not None:
            self._catalog = catalog
            lease = self.store.leases.acquire(catalog.version_vector)
            self._finalizer = weakref.finalize(self, lease.release)
        else:
            self._finalizer = weakref.finalize(self, lambda: None)
        old()  # release the previous generation's lease (idempotent)

    def close(self) -> None:
        """Release the pinned snapshot lease (idempotent)."""
        self._finalizer()

    @property
    def closed(self) -> bool:
        """Whether the snapshot lease has been released."""
        return not self._finalizer.alive

    def __enter__(self) -> "ModelRepo":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def refresh(self) -> "ModelRepo":
        """Re-pin at the store's latest snapshot; returns self."""
        self._pin(None)
        return self

    # -- introspection ---------------------------------------------------------

    @property
    def version(self):
        """Pinned version (vector on sharded stores); None before any pin."""
        return None if self._catalog is None else self._catalog.version

    @property
    def base(self) -> Optional["ModelRepo"]:
        """The base repo this one stores delta variants against, if any."""
        return self._base

    def _tid(self, name: str) -> str:
        return f"{self.prefix}/{name}"

    def leaf_ids(self) -> List[str]:
        """Sorted tensor ids under this prefix at the pinned snapshot."""
        if self._catalog is None:
            return []
        want = self.prefix + "/"
        return [tid for tid in self._catalog if tid.startswith(want)]

    def exists(self) -> bool:
        """Whether the pinned snapshot holds any weights for this prefix."""
        return bool(self.leaf_ids())

    def __repr__(self) -> str:
        kind = f" variant-of={self._base.prefix!r}" if self._base else ""
        return (f"ModelRepo({self.prefix!r}, version={self.version}{kind}, "
                f"{'closed' if self.closed else 'live'})")

    # -- writes ----------------------------------------------------------------

    def save(self, params: Any) -> List[str]:
        """Persist a param tree: one FTSF tensor per leaf, ONE commit.

        Each leaf is copied to the host with its bytes (bfloat16 included,
        see :func:`repro_torch.tree.to_numpy`). Re-saving atomically
        replaces the previous generation. On a variant repo each leaf
        stages via ``put_variant`` against the base repo's same-named
        leaf. The repo re-pins to the just-committed snapshot, so a
        following ``load`` reads what was saved. Returns the leaf ids.
        """
        with self.store.batch(op=f"SAVE WEIGHTS {self.prefix}") as batch:
            tids = []
            for name, leaf in leaves(params):
                arr = to_numpy(leaf)
                if self._base is not None:
                    tids.append(batch.put_variant(
                        arr, base_tid=self._base._tid(name),
                        tensor_id=self._tid(name), overwrite=True))
                else:
                    tids.append(batch.put(arr, tensor_id=self._tid(name),
                                          layout="ftsf", overwrite=True))
        self._pin(None)
        return tids

    def open_variant(self, name: str, *,
                     version: "VersionArg" = None) -> "ModelRepo":
        """A repo for ``<prefix>~<name>`` storing deltas against this one."""
        return ModelRepo(self.store, f"{self.prefix}~{name}",
                         version=version, base=self)

    # -- reads -----------------------------------------------------------------

    def _requests(self, template: Any) -> Tuple[
            List[Tuple[str, Optional[Sequence]]], List[Any]]:
        flat = leaves(template)
        return [(self._tid(name), None) for name, _ in flat], \
            [leaf for _, leaf in flat]

    def load(self, template: Any, *, device: Any = None,
             version: "VersionArg" = None,
             io: Optional[ReadExecutor] = None,
             cache_partition: Optional[str] = None) -> Any:
        """Load the weight tree shaped and typed like ``template`` onto
        ``device`` (the store's, ``"cuda"`` by default).

        ``template`` (a tree of tensors: meta tensors from
        ``init_params(cfg, device="meta")`` will do) supplies the tree
        structure and leaf dtypes. The whole tree loads through ONE merged
        fetch plan against the repo's pinned catalog, a consistent
        generation even if a re-save lands mid-load. ``version=`` reads
        another snapshot without re-pinning; ``io=`` overrides the store's
        executor; ``cache_partition`` routes the fetched blocks into that
        block-cache priority class.
        """
        catalog = (self._catalog if version is None
                   else self.store.catalog(version))
        if catalog is None:
            raise KeyError(f"no weights saved under prefix "
                           f"{self.prefix!r} (empty store)")
        reqs, templ = self._requests(template)
        tensors = catalog.read_many(reqs, io=io,
                                    cache_partition=cache_partition,
                                    device=device or self.store.device)
        out = [t if t.dtype == leaf.dtype else t.to(leaf.dtype)
               for t, leaf in zip(tensors, templ)]
        return rebuild(template, iter(out))

    def stats(self) -> Dict[str, Any]:
        """Pinned-snapshot inventory: leaf count and stored bytes."""
        ids = self.leaf_ids()
        nbytes = 0
        if self._catalog is not None:
            nbytes = sum(self._catalog.entry(t).nbytes for t in ids)
        return {"prefix": self.prefix, "version": self.version,
                "leaves": len(ids), "stored_bytes": nbytes,
                "is_variant": self._base is not None}
