"""Multi-tenant serving gateway: admission control over the tensor store.

The port's copy of ``repro.serve.gateway`` (host-only logic: admission,
weighted fair queueing, coalesced cold starts, cache partitions), over the
port's :class:`~repro_torch.serve.repo.ModelRepo`; ``load_model`` lands
the weights on ``device``. ``serve.engine`` knows how to load one weight
tree; this module is the layer between request traffic and the store:

* **per-tenant quotas + weighted fair queueing** — every piece of work
  (weight loads, reads) is submitted on behalf of a tenant with a
  :class:`TenantPolicy`; a start-time-fair-queueing scheduler dispatches
  from per-tenant bounded queues by virtual start tag, so a flooding
  tenant cannot starve the others and each tenant's share tracks its
  weight;
* **cold-start coalescing** — concurrent ``load_model`` calls for the
  same ``(prefix, version)`` share ONE single-flight
  :meth:`~repro_torch.serve.repo.ModelRepo.load` (one merged ``read_many``
  plan, the delta-variant base chunks fetched once); the flight key pins
  the resolved version vector, so two tenants joining one flight get
  byte-identical trees even when a re-save lands mid-load;
* **cache partitioning** — each tenant's policy names a block-cache
  priority class (:meth:`repro_torch.lake.io.BlockCache.add_partition`); hot
  base-model weights live in a budgeted partition long-tail variant
  churn can never evict;
* **tail-latency SLOs** — per-tenant latency histograms on the virtual
  clock, per-tenant p99 targets wired onto the executor's request
  hedging (an explicit ``hedge_after_s``, or derived from the p99
  target), and **overload shedding**: a full tenant queue rejects with
  :class:`RetryAfter` (carrying an advisory backoff) instead of queueing
  into collapse.
"""

from __future__ import annotations

import threading
import weakref
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.store import DeltaTensorStore, VersionArg
from ..lake.io import LatencyHistogram
from .repo import ModelRepo

DEFAULT_PARTITION = "default"


def jain_index(values: Sequence[float]) -> Optional[float]:
    """Jain's fairness index over per-tenant allocations.

    ``(sum x)^2 / (n * sum x^2)`` — 1.0 when every tenant got an equal
    share, ``1/n`` when one tenant got everything. None for empty input.
    """
    xs = [float(v) for v in values]
    if not xs:
        return None
    sq = sum(x * x for x in xs)
    if sq == 0.0:
        return 1.0
    return (sum(xs) ** 2) / (len(xs) * sq)


class RetryAfter(RuntimeError):
    """Admission rejected: the tenant's queue is full (overload shedding).

    Carries an advisory ``retry_after_s`` (backlog / service rate, from
    the tenant's observed mean latency) — the gateway's equivalent of an
    HTTP 429 + Retry-After header. Bounded queues + rejection keep an
    overloaded gateway at its capacity instead of collapsing under an
    unbounded backlog.
    """

    def __init__(self, tenant: str, retry_after_s: float):
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"tenant {tenant!r} queue full; retry after "
            f"{self.retry_after_s:.3f}s")


@dataclass(frozen=True)
class TenantPolicy:
    """Admission/quota/SLO knobs for one tenant.

    ``weight`` sets the tenant's fair share under contention;
    ``max_inflight`` caps its concurrently executing requests;
    ``queue_limit`` bounds its wait queue (beyond it, submissions shed
    with :class:`RetryAfter`). ``p99_target_s`` is the tenant's
    tail-latency SLO: reported in :meth:`Gateway.slo_report` and — when
    ``hedge_after_s`` is not set explicitly — used to derive a hedge
    threshold of half the target. ``cache_partition`` names the
    block-cache priority class this tenant's reads fill (create it via
    ``Gateway(partitions={...})``).
    """

    weight: float = 1.0
    max_inflight: int = 2
    queue_limit: int = 64
    p99_target_s: Optional[float] = None
    hedge_after_s: Optional[float] = None
    cache_partition: str = DEFAULT_PARTITION

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if self.queue_limit < 0:
            raise ValueError("queue_limit must be >= 0")

    @property
    def effective_hedge_s(self) -> Optional[float]:
        """Hedge threshold: explicit, else half the p99 target, else off."""
        if self.hedge_after_s is not None:
            return self.hedge_after_s
        if self.p99_target_s is not None:
            return 0.5 * self.p99_target_s
        return None


@dataclass
class _Job:
    """One admitted unit of work waiting in a tenant queue."""

    fn: Callable[[], Any]
    future: Future
    cost: float
    stag: float           # SFQ virtual start tag
    t_enqueue: float      # clock() at submission (queueing counts in SLO)


class _TenantState:
    """Scheduler-side bookkeeping for one tenant."""

    __slots__ = ("name", "policy", "queue", "inflight", "vfinish",
                 "admitted", "completed", "failed", "rejected", "coalesced",
                 "work_done", "latency")

    def __init__(self, name: str, policy: TenantPolicy):
        self.name = name
        self.policy = policy
        self.queue: "deque[_Job]" = deque()
        self.inflight = 0
        self.vfinish = 0.0     # finish tag of this tenant's last-tagged job
        self.admitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.coalesced = 0
        self.work_done = 0.0
        self.latency = LatencyHistogram()


class Gateway:
    """Admission/scheduling layer between request traffic and the store.

    ``max_inflight`` bounds total concurrently executing requests (the
    gateway's service capacity — its private worker pool size).
    ``partitions`` maps block-cache priority-class names to byte budgets
    — an int, or ``{"bytes": n, "pinned": True}`` for a pinned class that
    rejects overflow instead of evicting (hot-base weights) — created on
    the store's executor at construction and nameable from tenant
    policies. ``clock`` timestamps per-request latency — benchmarks pass
    the modeled store's virtual clock. ``default_policy`` applies to
    tenants that were never :meth:`register`\\ ed.

    Lifecycle matches ``TensorRef``/``StreamLoader``/``ModelRepo``:
    ``close()``, context manager, and a GC weakref finalizer all release
    the worker pool; queued work is cancelled with :class:`RetryAfter`.
    """

    def __init__(self, store: DeltaTensorStore, *, max_inflight: int = 8,
                 partitions: Optional[Dict[str, int]] = None,
                 default_policy: Optional[TenantPolicy] = None,
                 load_cost: float = 4.0,
                 clock: Optional[Callable[[], float]] = None):
        self.store = store
        self.max_inflight = max(1, int(max_inflight))
        self.default_policy = default_policy or TenantPolicy()
        self.load_cost = float(load_cost)
        self.clock = clock or _default_clock()
        for name, spec in (partitions or {}).items():
            if isinstance(spec, dict):
                store.io.cache.add_partition(
                    name, int(spec["bytes"]),
                    pinned=bool(spec.get("pinned", False)))
            else:
                store.io.cache.add_partition(name, int(spec))
        self._lock = threading.RLock()
        self._tenants: Dict[str, _TenantState] = {}
        self._flights: Dict[Tuple[str, Tuple[int, ...], str], Future] = {}
        self._vtime = 0.0
        self._inflight = 0
        self._closed = False
        self._flights_created = 0
        self._coalesced_total = 0
        self._pool = ThreadPoolExecutor(max_workers=self.max_inflight,
                                        thread_name_prefix="gateway")
        self._finalizer = weakref.finalize(self, self._pool.shutdown, False)

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        """Stop admitting, cancel queued work, release the pool (idempotent).

        In-flight requests run to completion; queued (not yet dispatched)
        jobs fail with :class:`RetryAfter`.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            dropped: List[_Job] = []
            for st in self._tenants.values():
                dropped.extend(st.queue)
                st.queue.clear()
        for job in dropped:
            job.future.set_exception(RetryAfter("<gateway closed>", 0.0))
        self._finalizer()

    @property
    def closed(self) -> bool:
        """Whether :meth:`close` has run (worker pool released)."""
        return self._closed or not self._finalizer.alive

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- tenants ---------------------------------------------------------------

    def register(self, tenant: str, policy: TenantPolicy) -> None:
        """Attach ``policy`` to ``tenant`` (before or between requests)."""
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                self._tenants[tenant] = _TenantState(tenant, policy)
            else:
                st.policy = policy

    def _tenant(self, name: str) -> _TenantState:
        st = self._tenants.get(name)
        if st is None:
            st = self._tenants[name] = _TenantState(name, self.default_policy)
        return st

    # -- admission + weighted fair queueing ------------------------------------

    def submit(self, tenant: str, fn: Callable[[], Any], *,
               cost: float = 1.0) -> "Future[Any]":
        """Admit one unit of work for ``tenant``; returns its Future.

        Work is tagged with a start-time-fair-queueing virtual tag
        (``max(V, tenant's last finish)``; finish = start +
        ``cost/weight``) and dispatched lowest-tag-first whenever the
        gateway and the tenant both have an inflight slot free — under
        contention each tenant's throughput share tracks its weight
        regardless of arrival order. A full tenant queue sheds the
        request with :class:`RetryAfter` instead of growing the backlog.
        """
        cost = max(float(cost), 1e-9)
        with self._lock:
            if self._closed:
                raise RuntimeError("gateway is closed")
            st = self._tenant(tenant)
            pol = st.policy
            no_slot = (self._inflight >= self.max_inflight
                       or st.inflight >= pol.max_inflight)
            if no_slot and len(st.queue) >= pol.queue_limit:
                st.rejected += 1
                raise RetryAfter(tenant, self._retry_after_locked(st))
            stag = max(self._vtime, st.vfinish)
            st.vfinish = stag + cost / pol.weight
            job = _Job(fn=fn, future=Future(), cost=cost, stag=stag,
                       t_enqueue=self.clock())
            st.queue.append(job)
            st.admitted += 1
            self._dispatch_locked()
            return job.future

    def _retry_after_locked(self, st: _TenantState) -> float:
        # advisory backoff: backlog ahead of the caller / service rate,
        # from the tenant's observed mean latency (floor: one mean)
        mean = st.latency.mean or 0.010
        backlog = len(st.queue) + st.inflight
        return mean * max(1.0, backlog / st.policy.max_inflight)

    def _dispatch_locked(self) -> None:
        while self._inflight < self.max_inflight:
            best: Optional[_TenantState] = None
            for st in self._tenants.values():
                if not st.queue or st.inflight >= st.policy.max_inflight:
                    continue
                if best is None or st.queue[0].stag < best.queue[0].stag:
                    best = st
            if best is None:
                return
            job = best.queue.popleft()
            best.inflight += 1
            self._inflight += 1
            self._vtime = max(self._vtime, job.stag)
            self._pool.submit(self._run, best, job)

    def _run(self, st: _TenantState, job: _Job) -> None:
        hedge = st.policy.effective_hedge_s
        try:
            if hedge is not None:
                result = self.store.io.hedged(job.fn, hedge_after_s=hedge)
            else:
                result = job.fn()
            err: Optional[BaseException] = None
        except BaseException as e:  # surfaced via the future
            result, err = None, e
        done = self.clock()
        with self._lock:
            st.inflight -= 1
            self._inflight -= 1
            st.latency.observe(done - job.t_enqueue)
            if err is None:
                st.completed += 1
                st.work_done += job.cost
            else:
                st.failed += 1
            if not self._closed:
                self._dispatch_locked()
        if err is None:
            job.future.set_result(result)
        else:
            job.future.set_exception(err)

    # -- serving verbs ---------------------------------------------------------

    def load_model(self, tenant: str, prefix: str, template: Any, *,
                   version: VersionArg = None,
                   device: Any = None) -> "Future[Any]":
        """Cold-start a model: coalesced, admission-controlled weight load.

        Resolves ``(prefix, version)`` to a concrete pinned version
        vector FIRST, then joins (or creates) the single-flight for that
        key: N concurrent tenants cold-starting one model share one
        :meth:`ModelRepo.load <repro_torch.serve.repo.ModelRepo.load>` — one
        merged fetch plan, each chunk (and each delta-variant base
        chunk) fetched once — and all receive the same pinned
        generation, byte-identical, even if a re-save lands mid-flight.
        A save that commits *before* a later call resolves simply maps
        that call to a new key: fresh flight, fresh weights. Blocks land
        in the calling tenant's cache partition, and the tensors on
        ``device`` (the store's, ``"cuda"`` by default); the flight key
        includes the device.
        """
        with self._lock:
            if self._closed:
                raise RuntimeError("gateway is closed")
            vector = self.store.catalog(version).version_vector
            dev = str(device or self.store.device)
            key = (prefix, vector, dev)
            flight = self._flights.get(key)
            if flight is not None:
                st = self._tenant(tenant)
                st.coalesced += 1
                self._coalesced_total += 1
                return flight
            part = self._tenant(tenant).policy.cache_partition

            def do_load() -> Any:
                with ModelRepo(self.store, prefix, version=vector) as repo:
                    return repo.load(template, cache_partition=part,
                                     device=dev)

            fut = self.submit(tenant, do_load, cost=self.load_cost)
            self._flights[key] = fut
            self._flights_created += 1
        fut.add_done_callback(lambda _f: self._drop_flight(key))
        return fut

    def _drop_flight(self, key: Tuple[str, Tuple[int, ...], str]) -> None:
        with self._lock:
            self._flights.pop(key, None)

    def read(self, tenant: str, tid: str,
             slices: Optional[Sequence] = None, *,
             version: VersionArg = None) -> "Future[Any]":
        """Admission-controlled tensor (or slice) read for ``tenant``.

        Pass a concrete ``version`` (vector) for warm-path reads: the
        pinned catalog is cached, so a fully block-cached read issues
        zero object-store requests. Blocks land in the tenant's cache
        partition — a hot tenant's base-model reads refill (and are
        protected by) its priority class.
        """
        part = self._tenant(tenant).policy.cache_partition
        return self.submit(
            tenant,
            lambda: self.store.read_many([(tid, slices)], version=version,
                                         cache_partition=part)[0])

    # -- observability ---------------------------------------------------------

    def tenant_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant counters + latency summary (admission, shedding,
        coalescing, fair-share work done, p50/p95/p99)."""
        with self._lock:
            return {name: {"admitted": st.admitted,
                           "completed": st.completed,
                           "failed": st.failed,
                           "rejected": st.rejected,
                           "coalesced": st.coalesced,
                           "queued": len(st.queue),
                           "inflight": st.inflight,
                           "work_done": st.work_done,
                           "weight": st.policy.weight,
                           "latency": st.latency.summary()}
                    for name, st in self._tenants.items()}

    def stats(self) -> Dict[str, Any]:
        """Gateway-wide counters: flights, coalescing, inflight, shed."""
        with self._lock:
            return {"tenants": len(self._tenants),
                    "inflight": self._inflight,
                    "max_inflight": self.max_inflight,
                    "flights_created": self._flights_created,
                    "coalesced_hits": self._coalesced_total,
                    "open_flights": len(self._flights),
                    "rejected": sum(st.rejected
                                    for st in self._tenants.values()),
                    "cache_partitions": self.store.io.cache.partitions()}

    def slo_report(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant p99 vs target: ``{p99_s, target_s, met, hedge_s}``.

        ``met`` is None when the tenant has no target or no samples.
        """
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            tenants = list(self._tenants.items())
        for name, st in tenants:
            p99 = st.latency.p99()
            target = st.policy.p99_target_s
            met = (None if target is None or p99 is None
                   else bool(p99 <= target))
            out[name] = {"p99_s": p99, "target_s": target, "met": met,
                         "hedge_s": st.policy.effective_hedge_s}
        return out

    def fairness(self, tenants: Optional[Sequence[str]] = None,
                 metric: str = "work_done") -> Optional[float]:
        """Jain fairness index over per-tenant ``work_done`` (weighted:
        each tenant's share is divided by its policy weight first, so
        perfect weighted-fair service scores 1.0)."""
        with self._lock:
            states = [self._tenants[t] for t in tenants] if tenants \
                else list(self._tenants.values())
            vals = [getattr(st, metric) / st.policy.weight for st in states]
        return jain_index(vals)


def _default_clock() -> Callable[[], float]:
    import time
    return time.perf_counter
