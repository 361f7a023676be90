"""Snapshot leases: refcounted pins that make maintenance safe for readers.

Since the handle API every read is snapshot-pinned: a
:class:`~repro_torch.core.catalog.TensorRef` keeps returning the same bytes no
matter what writers do afterwards. That guarantee only holds while the
pinned version's data files still exist — which ``vacuum`` knows nothing
about unless someone tells it. This module is the telling:

* every ref **acquires a lease** on its catalog's version vector at open
  and releases it on ``close()`` / context-manager exit / garbage
  collection (a ``weakref.finalize`` backstop, so even leaked refs cannot
  pin a snapshot forever);
* the :class:`LeaseRegistry` refcounts leases per version vector.
  Registries are shared **per (object store, root)** within the process,
  so several ``DeltaTensorStore`` clients over the same physical store see
  each other's pins (Deep Lake ties dataset version retention to active
  reader views the same way);
* maintenance (``store.vacuum``) folds ``leased_versions(shard)`` into its
  retention horizon: files referenced by any leased snapshot are never
  deleted, so a pinned ref reads identical bytes before, during, and after
  concurrent compact+vacuum.

Leases are a **per-process** mechanism: two processes vacuum-ing the same
bucket do not see each other's refs. Cross-process retention is what the
``keep_versions`` / TTL half of :class:`RetentionPolicy` is for — leases
protect live readers, the policy protects everyone else.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

from ..lake.io import store_scope as lease_scope  # noqa: F401 (re-export)

VersionVector = Tuple[int, ...]

# process-wide registries keyed by (object-store scope, store root): every
# client of one physical store shares one registry, so leases taken through
# any client are visible to maintenance run through any other. Weak values:
# each DeltaTensorStore (and every live Lease) holds its registry strongly,
# so a registry lives exactly as long as anything that could use it —
# transient stores don't accumulate dead registries for the process life.
_registries: "weakref.WeakValueDictionary[tuple, LeaseRegistry]" = \
    weakref.WeakValueDictionary()
_registries_lock = threading.Lock()


def registry_for(scope: tuple, root: str) -> "LeaseRegistry":
    """The shared registry for one physical (object store, root) pair."""
    key = (scope, root.rstrip("/"))
    with _registries_lock:
        reg = _registries.get(key)
        if reg is None:
            reg = LeaseRegistry()
            _registries[key] = reg
        return reg


@dataclass(frozen=True)
class RetentionPolicy:
    """How many non-leased historical versions maintenance must keep.

    ``keep_versions=K`` retains the newest K versions of every shard table
    (K=1 keeps only the latest snapshot — the classic vacuum). ``ttl_s``
    additionally retains every version whose commit is younger than the
    TTL, whatever K says. Leased versions are always retained on top of
    this policy; they are pins, not policy.
    """

    keep_versions: int = 1
    ttl_s: Optional[float] = None

    def __post_init__(self):
        if self.keep_versions < 1:
            raise ValueError(
                f"keep_versions must be >= 1, got {self.keep_versions}")


class Lease:
    """One refcount held on a version vector; release is idempotent."""

    __slots__ = ("_registry", "version_vector", "_released")

    def __init__(self, registry: "LeaseRegistry", vector: VersionVector):
        self._registry = registry
        self.version_vector = vector
        self._released = False

    def release(self) -> None:
        """Drop this pin (idempotent); maintenance may then reclaim."""
        if not self._released:
            self._released = True
            self._registry._release(self.version_vector)

    @property
    def released(self) -> bool:
        """Whether :meth:`release` already ran."""
        return self._released

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def __repr__(self) -> str:
        state = "released" if self._released else "live"
        return f"Lease({self.version_vector}, {state})"


class LeaseRegistry:
    """Thread-safe refcounts of live snapshot pins, per version vector."""

    def __init__(self):
        self._counts: Dict[VersionVector, int] = {}
        self._lock = threading.Lock()

    def acquire(self, vector: VersionVector) -> Lease:
        """Take one refcounted pin on ``vector``; pair with ``release``."""
        vv = tuple(int(v) for v in vector)
        with self._lock:
            self._counts[vv] = self._counts.get(vv, 0) + 1
        return Lease(self, vv)

    def _release(self, vector: VersionVector) -> None:
        with self._lock:
            n = self._counts.get(vector, 0) - 1
            if n > 0:
                self._counts[vector] = n
            else:
                self._counts.pop(vector, None)

    # -- introspection (what vacuum consumes) --------------------------------

    def leased_vectors(self) -> Dict[VersionVector, int]:
        """Live vectors -> refcount (a snapshot; safe to iterate)."""
        with self._lock:
            return dict(self._counts)

    def leased_versions(self, shard: int) -> Set[int]:
        """Versions of ``shard`` pinned by any live lease.

        Vectors shorter than ``shard+1`` (from clients that opened the
        store before it was sharded — cannot happen today, defensive) are
        ignored rather than crashing maintenance.
        """
        with self._lock:
            return {vv[shard] for vv in self._counts if len(vv) > shard}

    @property
    def active(self) -> int:
        """Number of distinct leased vectors."""
        with self._lock:
            return len(self._counts)

    def __len__(self) -> int:
        return self.active
