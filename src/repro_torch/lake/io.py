"""Shared parallel read-path subsystem for the lake layer.

Every read consumer in the framework (``DeltaTable.scan``, the tensor
store's ``get``/``get_coo``/``get_slice``, the FTSF training loader, serve
weight loading) funnels its object-store fetches through one
:class:`ReadExecutor`, which provides:

* a **bounded I/O thread pool** so a multi-chunk read costs the makespan of
  concurrent gets, not the sum of per-file RTTs (Deep Lake's streaming
  fetch layer is the reference design here);
* an **LRU block cache** keyed by ``(store, object key)`` holding immutable
  data-file bytes — delta data files are write-once, so cached blocks can
  never go stale; log/metadata reads bypass the cache. The cache is split
  into **priority-class partitions** with independent byte budgets
  (``cache.add_partition``): long-tail churn in one class can never evict
  another class's working set — how the serving gateway keeps a hot base
  model resident while variant traffic churns;
* **transparent decompression**: part files framed by a chunk-blob codec
  (:mod:`repro_torch.lake.compression`) are unframed as they arrive off the
  wire, so the cache stores *decoded* blocks — a warm read pays neither
  the bandwidth nor the decode cost — while the object store (and any
  modeled :class:`~repro_torch.lake.object_store.LatencyModel`) charges the
  compressed size; unframed bytes pass through untouched. Decode runs on
  a **staged pool** (``decode_workers``) with a bounded handoff queue, so
  decompression of chunk *k* overlaps the fetch of chunk *k+1* instead of
  serializing behind the wire — ``ReadStats.decode_s`` /
  ``decode_overlap_frac`` carry the evidence;
* **request hedging** (straggler mitigation): if a get hasn't finished
  after ``hedge_after_s`` a duplicate is raced against it and the first
  result wins — object-store reads are idempotent so duplicates are safe;
* a **work pool** for composite background jobs (loader prefetch steps,
  parallel weight loads). Composite jobs may block on I/O futures; I/O
  tasks never submit work, so the two-pool split is deadlock-free by
  construction.
"""

from __future__ import annotations

import itertools
import math
import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from .compression import decode_frame, frame_info, is_framed

DEFAULT_MAX_WORKERS = 8
DEFAULT_CACHE_BYTES = 64 << 20
# staged decode: frames are unwrapped on a small dedicated pool so the
# fetch thread goes straight back to the wire — decompression of chunk k
# overlaps the fetch of chunk k+1. 0 disables the stage (decode inline on
# the fetch thread, the pre-pipeline behavior).
DEFAULT_DECODE_WORKERS = 2

# delta frames may chain (defensively bounded; writers only ever target
# non-delta bases, so a well-formed store needs depth 1)
MAX_DELTA_DEPTH = 4


def content_cache_key(content_hash: str) -> str:
    """Block-cache name for content-addressed bytes.

    Two add-actions aliasing the same stored object (dedup) or a delta
    frame reconstructing against a base share one cache entry when their
    fetches are named by content hash instead of object key.
    """
    return "cas:" + content_hash

# monotonically increasing token per object-store instance: cache keys must
# survive id() reuse after GC, so the token rides on the store object itself
_store_tokens = itertools.count()


def _store_token(store: Any) -> int:
    tok = getattr(store, "_io_cache_token", None)
    if tok is None:
        tok = next(_store_tokens)
        try:
            store._io_cache_token = tok
        except AttributeError:  # __slots__ store: fall back to identity
            return id(store)
    return tok


def store_scope(store: Any) -> tuple:
    """Stable in-process identity for one *physical* object store.

    Filesystem-backed stores identify by their root path, so two
    ``LocalFSObjectStore`` clients of the same directory compare equal —
    cross-client coordination (snapshot leases, in-flight upload guards)
    keys on this. Stores without a path identity fall back to per-instance
    identity via the cache token.
    """
    root = getattr(store, "root", None)
    if isinstance(root, str):
        return ("fs", root)
    return ("instance", _store_token(store))


class LatencyHistogram:
    """Thread-safe log-bucketed latency histogram with quantile accessors.

    Buckets are geometric (HDR-histogram style): ~4% relative resolution
    from 1 µs up past 1000 s in O(1) memory, so recording a sample is a
    lock + an integer increment — cheap enough to sit on every object get.
    Quantiles interpolate inside the winning bucket, which keeps p50/p95/
    p99 honest to within one bucket width. On the modeled object store the
    recorded samples are **virtual-clock** durations (queueing + RTT +
    transfer, see :meth:`LatencyModel.request_latency_s`), so benchmark
    tail latencies are deterministic rather than scheduler noise.
    """

    MIN_S = 1e-6
    GROWTH = 1.04
    N_BUCKETS = 560  # MIN_S * GROWTH**560 ≈ 3.3e3 s — covers any sane read

    def __init__(self):
        self._counts = [0] * self.N_BUCKETS
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def _bucket(self, seconds: float) -> int:
        if seconds <= self.MIN_S:
            return 0
        b = int(math.log(seconds / self.MIN_S) / math.log(self.GROWTH))
        return min(b, self.N_BUCKETS - 1)

    def observe(self, seconds: float) -> None:
        """Record one latency sample (negative samples clamp to 0)."""
        s = max(0.0, float(seconds))
        with self._lock:
            self._counts[self._bucket(s)] += 1
            self._count += 1
            self._sum += s
            if s > self._max:
                self._max = s

    @property
    def count(self) -> int:
        """Number of recorded samples."""
        with self._lock:
            return self._count

    @property
    def mean(self) -> float:
        """Mean recorded latency in seconds (0.0 when empty)."""
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    @property
    def max(self) -> float:
        """Largest recorded sample in seconds."""
        with self._lock:
            return self._max

    def quantile(self, q: float) -> Optional[float]:
        """The ``q`` quantile (0..1) in seconds; None when empty.

        Returns the bucket's geometric midpoint, capped at the observed
        max so p99 of a single-valued distribution equals that value.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            if self._count == 0:
                return None
            rank = q * (self._count - 1)
            seen = 0
            for b, c in enumerate(self._counts):
                seen += c
                if seen > rank:
                    lo = self.MIN_S * self.GROWTH ** b
                    return min(lo * math.sqrt(self.GROWTH), self._max)
            return self._max  # pragma: no cover - rank < count always hits

    def p50(self) -> Optional[float]:
        """Median latency in seconds (None when empty)."""
        return self.quantile(0.50)

    def p95(self) -> Optional[float]:
        """95th-percentile latency in seconds (None when empty)."""
        return self.quantile(0.95)

    def p99(self) -> Optional[float]:
        """99th-percentile latency in seconds (None when empty)."""
        return self.quantile(0.99)

    def summary(self) -> Dict[str, Optional[float]]:
        """``{count, mean_s, p50_s, p95_s, p99_s, max_s}`` for reporting."""
        return {"count": self.count, "mean_s": self.mean,
                "p50_s": self.p50(), "p95_s": self.p95(),
                "p99_s": self.p99(), "max_s": self.max}

    def reset(self) -> None:
        """Drop every recorded sample (benchmark epochs)."""
        with self._lock:
            self._counts = [0] * self.N_BUCKETS
            self._count = 0
            self._sum = 0.0
            self._max = 0.0


@dataclass
class ReadStats:
    """Counters for the read path (thread-safe)."""

    gets: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    hedges_launched: int = 0
    hedges_won: int = 0
    # chunk-blob decompression: frames unwrapped off the wire, and the
    # compressed (wire) vs decoded sizes they moved — the space claim
    frames_decoded: int = 0
    frame_bytes_wire: int = 0
    frame_bytes_decoded: int = 0
    # variant delta frames reconstructed against their base object
    deltas_reconstructed: int = 0
    # read_many fetch scheduling: merged plans built, requests they
    # covered, unique keys actually fetched, and references that were
    # deduplicated away (a shared chunk key counted once per extra
    # requester) — the "shared chunk fetched once per plan" claim
    plans: int = 0
    plan_requests: int = 0
    plan_keys_fetched: int = 0
    plan_keys_deduped: int = 0
    # staged decode: real seconds spent unwrapping frames, the portion of
    # that time during which at least one fetch was in flight (wall-clock
    # sampled — the overlap evidence), frames decoded off the fetch
    # thread, and bytes handed to an accelerator device by device reads
    decode_s: float = 0.0
    decode_overlap_s: float = 0.0
    decodes_offloaded: int = 0
    bytes_to_device: int = 0
    # per-request latency histogram (virtual-clock durations on a modeled
    # store, wall-clock otherwise); see LatencyHistogram
    latency: LatencyHistogram = field(default_factory=LatencyHistogram,
                                      repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @property
    def decode_overlap_frac(self) -> float:
        """Fraction of decode seconds that overlapped an in-flight fetch."""
        return self.decode_overlap_s / self.decode_s if self.decode_s else 0.0

    def bump(self, **deltas: float) -> None:
        """Atomically add ``deltas`` to the named counters."""
        with self._lock:
            for k, d in deltas.items():
                setattr(self, k, getattr(self, k) + d)

    def reset(self) -> None:
        """Zero every counter (benchmark epochs)."""
        with self._lock:
            self.gets = self.cache_hits = self.cache_misses = 0
            self.hedges_launched = self.hedges_won = 0
            self.frames_decoded = 0
            self.frame_bytes_wire = self.frame_bytes_decoded = 0
            self.deltas_reconstructed = 0
            self.plans = self.plan_requests = 0
            self.plan_keys_fetched = self.plan_keys_deduped = 0
            self.decode_s = self.decode_overlap_s = 0.0
            self.decodes_offloaded = 0
            self.bytes_to_device = 0
        self.latency.reset()


DEFAULT_PARTITION = "default"


class _Partition:
    """One priority class inside the block cache: its own LRU + budget."""

    __slots__ = ("capacity", "pinned", "blocks", "nbytes", "evictions")

    def __init__(self, capacity_bytes: int, pinned: bool = False):
        self.capacity = int(capacity_bytes)
        self.pinned = pinned
        self.blocks: "OrderedDict[Tuple[int, str], bytes]" = OrderedDict()
        self.nbytes = 0
        self.evictions = 0


class BlockCache:
    """Thread-safe LRU over immutable blocks, bounded by per-partition bytes.

    The cache is split into **partitions** (priority classes), each with
    its own byte budget and LRU order. Eviction pressure never crosses a
    partition boundary: a long-tail scan churning the ``default``
    partition cannot evict blocks a higher-priority class (a pinned hot
    base model) holds — the serving gateway's cache-isolation story.
    Lookups are partition-blind (one global key -> partition map), so a
    block cached by any class serves every reader; a ``get`` that names a
    different partition *promotes* the block into it (a hot-class read
    rescues a base-model block that first arrived as a long-tail delta
    prefetch). ``add_partition(pinned=True)`` makes a class reject inserts
    past its budget instead of evicting — a hard pin for working sets
    that must never churn — and its residents never demote: lower-priority
    readers are served from the pinned copy in place.

    ``BlockCache(capacity_bytes)`` with no extra partitions behaves
    exactly like the old single-LRU cache (one ``default`` partition).
    """

    def __init__(self, capacity_bytes: int = DEFAULT_CACHE_BYTES):
        self.capacity = int(capacity_bytes)
        self._parts: Dict[str, _Partition] = {
            DEFAULT_PARTITION: _Partition(self.capacity)}
        self._where: Dict[Tuple[int, str], str] = {}
        self._lock = threading.Lock()

    # -- partition management -------------------------------------------------

    def add_partition(self, name: str, capacity_bytes: int, *,
                      pinned: bool = False) -> None:
        """Create (or resize) priority class ``name`` with its own budget.

        ``pinned`` partitions reject inserts past their budget instead of
        evicting — resident blocks can only leave via ``invalidate`` /
        ``clear``. Re-adding an existing partition adjusts its budget (and
        evicts down to it for LRU partitions) without dropping blocks.
        """
        if name == DEFAULT_PARTITION:
            raise ValueError("the default partition always exists; "
                             "size it via the cache capacity")
        with self._lock:
            part = self._parts.get(name)
            if part is None:
                self._parts[name] = _Partition(capacity_bytes, pinned)
                return
            part.capacity = int(capacity_bytes)
            part.pinned = pinned
            if not pinned:
                self._evict_locked(part)

    def partitions(self) -> Dict[str, Dict[str, int]]:
        """Per-partition occupancy: name -> {capacity, nbytes, blocks,
        evictions} (the gateway's cache-isolation observability)."""
        with self._lock:
            return {name: {"capacity_bytes": p.capacity, "nbytes": p.nbytes,
                           "blocks": len(p.blocks), "evictions": p.evictions,
                           "pinned": int(p.pinned)}
                    for name, p in self._parts.items()}

    def _evict_locked(self, part: _Partition) -> None:
        while part.nbytes > part.capacity:
            key, evicted = part.blocks.popitem(last=False)
            part.nbytes -= len(evicted)
            part.evictions += 1
            self._where.pop(key, None)

    # -- block access ----------------------------------------------------------

    def get(self, key: Tuple[int, str],
            partition: Optional[str] = None) -> Optional[bytes]:
        """The cached block (refreshing its LRU position) or None.

        Lookup spans all partitions. When ``partition`` names a different
        class than the block's current home, the hit **promotes** the
        block into the named partition (subject to that partition's
        budget), so priority follows the readers actually touching it —
        unless the home is *pinned*: a pinned class never loses residents
        to lower-priority readers (the long-tail variant churn reading a
        hot tenant's base chunks must not demote them into its own
        churning partition).
        """
        with self._lock:
            home = self._where.get(key)
            if home is None:
                return None
            part = self._parts[home]
            data = part.blocks[key]
            if partition is not None and partition != home \
                    and partition in self._parts and not part.pinned:
                self._put_locked(key, data, partition)
            else:
                part.blocks.move_to_end(key)
            return data

    def _put_locked(self, key: Tuple[int, str], data: bytes,
                    partition: str) -> None:
        part = self._parts[partition]
        if len(data) > part.capacity:
            return  # never churn a whole partition for one oversized block
        if part.pinned and part.nbytes + len(data) > part.capacity:
            return  # pinned class is full: reject, never evict residents
        home = self._where.get(key)
        if home is not None:
            old_part = self._parts[home]
            if old_part.pinned and home != partition:
                old_part.blocks.move_to_end(key)
                return  # pinned residents never demote to another class
            old = old_part.blocks.pop(key)
            old_part.nbytes -= len(old)
        part.blocks[key] = data
        part.nbytes += len(data)
        self._where[key] = partition
        self._evict_locked(part)

    def put(self, key: Tuple[int, str], data: bytes,
            partition: Optional[str] = None) -> None:
        """Insert a block into ``partition`` (default class when None),
        evicting that partition's LRU entries past its byte budget."""
        name = partition if partition in self._parts else DEFAULT_PARTITION
        with self._lock:
            self._put_locked(key, data, name)

    def invalidate(self, key: Tuple[int, str]) -> None:
        """Drop one block (deleted objects must not serve from cache)."""
        with self._lock:
            home = self._where.pop(key, None)
            if home is not None:
                part = self._parts[home]
                old = part.blocks.pop(key, None)
                if old is not None:
                    part.nbytes -= len(old)

    def clear(self) -> None:
        """Drop every cached block (all partitions; budgets survive)."""
        with self._lock:
            for part in self._parts.values():
                part.blocks.clear()
                part.nbytes = 0
            self._where.clear()

    @property
    def nbytes(self) -> int:
        """Total bytes currently cached across all partitions."""
        with self._lock:
            return sum(p.nbytes for p in self._parts.values())

    def __len__(self) -> int:
        with self._lock:
            return sum(len(p.blocks) for p in self._parts.values())


class ReadExecutor:
    """Bounded thread pool + block cache + hedging for object-store reads.

    ``max_workers`` bounds concurrent in-flight gets (the paper's 1 Gbps
    testbed saturates around 8 streams; width is configurable so benchmarks
    can sweep it). ``cache_bytes=0`` disables caching. ``hedge_after_s``
    enables hedged gets on every fetch routed through this executor.

    ``decode_workers`` sizes the staged-decode pool: framed (compressed)
    blocks come off the wire on an I/O thread but are decompressed on this
    separate stage, so decode of chunk *k* overlaps the fetch of *k+1*.
    ``decode_queue`` bounds frames parked between the stages (backpressure:
    when decoders fall behind, fetch threads block handing off rather than
    buffering the whole scan). ``decode_workers=0`` restores inline decode
    on the fetch thread.
    """

    def __init__(self, max_workers: int = DEFAULT_MAX_WORKERS, *,
                 cache_bytes: int = DEFAULT_CACHE_BYTES,
                 hedge_after_s: Optional[float] = None,
                 hedge_attempts: int = 2,
                 decode_workers: Optional[int] = None,
                 decode_queue: Optional[int] = None):
        self.max_workers = max(1, int(max_workers))
        self.cache = BlockCache(cache_bytes)
        self.stats = ReadStats()
        self.hedge_after_s = hedge_after_s
        self.hedge_attempts = max(1, int(hedge_attempts))
        self.decode_workers = (DEFAULT_DECODE_WORKERS if decode_workers is None
                               else max(0, int(decode_workers)))
        self._io = ThreadPoolExecutor(
            max_workers=self.max_workers, thread_name_prefix="lakeio")
        self._work = ThreadPoolExecutor(
            max_workers=self.max_workers, thread_name_prefix="lakework")
        self._decode: Optional[ThreadPoolExecutor] = None
        if self.decode_workers:
            self._decode = ThreadPoolExecutor(
                max_workers=self.decode_workers,
                thread_name_prefix="lakedecode")
            slots = (4 * self.decode_workers if decode_queue is None
                     else max(1, int(decode_queue)))
            self._decode_slots = threading.BoundedSemaphore(slots)
        # gets currently on the wire (sampled by the decode stage as the
        # wall-clock overlap evidence)
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    # -- raw gets ------------------------------------------------------------

    def _timed_get(self, store: Any, key: str) -> bytes:
        # one *attempt* = one histogram sample (hedged retries each record
        # their own latency on their own thread). On a modeled store the
        # sample is the deterministic virtual-clock duration of this
        # request (queueing + RTT + transfer); otherwise wall clock.
        t0 = time.perf_counter()
        with self._inflight_lock:
            self._inflight += 1
        try:
            data = store.get(key)
        finally:
            with self._inflight_lock:
                self._inflight -= 1
        lm = getattr(store, "latency", None)
        lat = getattr(lm, "request_latency_s", lambda: None)()
        if lat is None:
            lat = time.perf_counter() - t0
        self.stats.latency.observe(lat)
        return data

    def _get_raw(self, store: Any, key: str) -> bytes:
        self.stats.bump(gets=1)
        if self.hedge_after_s is None or self.hedge_attempts <= 1:
            return self._timed_get(store, key)
        return self.hedged(lambda: self._timed_get(store, key),
                           hedge_after_s=self.hedge_after_s,
                           attempts=self.hedge_attempts)

    def _decode_wire(self, store: Any, data: bytes, depth: int = 0,
                     partition: Optional[str] = None) -> bytes:
        # unframe compressed part files here, off the wire: the cache (and
        # every consumer above) sees decoded bytes, while the store charged
        # bandwidth for the compressed size it actually moved. Delta frames
        # additionally reconstruct against their base object (fetched
        # inline on this thread — never re-submitted to the I/O pool, so a
        # saturated pool cannot deadlock on its own dependencies).
        info = frame_info(data)
        if info is None:
            return data
        if info.get("delta_base") is not None:
            if depth >= MAX_DELTA_DEPTH:
                raise ValueError(
                    f"delta base chain deeper than {MAX_DELTA_DEPTH}")
            self.stats.bump(deltas_reconstructed=1)
        wire = len(data)
        data = decode_frame(
            data,
            base_fetch=lambda bk, bh: self._base_bytes(store, bk, bh,
                                                       depth + 1, partition))
        self.stats.bump(frames_decoded=1, frame_bytes_wire=wire,
                        frame_bytes_decoded=len(data))
        return data

    def _base_bytes(self, store: Any, key: str,
                    content_hash: Optional[str] = None,
                    depth: int = 1,
                    partition: Optional[str] = None) -> bytes:
        # decoded bytes of a delta frame's base: content-hash-named cache
        # lookup first (shared with dedup'd reads of the base itself),
        # then a plain inline get + decode
        ck: Optional[Tuple[int, str]] = None
        if self.cache.capacity:
            name = content_cache_key(content_hash) if content_hash else key
            ck = (_store_token(store), name)
            hit = self.cache.get(ck, partition)
            if hit is not None:
                self.stats.bump(cache_hits=1)
                return hit
            self.stats.bump(cache_misses=1)
        data = self._decode_wire(store, self._get_raw(store, key), depth,
                                 partition)
        if ck is not None:
            self.cache.put(ck, data, partition)
        return data

    def _fetch_miss(self, store: Any, key: str,
                    cache_key: Optional[Tuple[int, str]],
                    partition: Optional[str] = None) -> bytes:
        # inline path (decode stage disabled): fetch and decode on the same
        # I/O thread, decode serializing ahead of this thread's next fetch
        raw = self._get_raw(store, key)
        data = self._decode_timed(store, raw, partition,
                                  self._virtual_done(store))
        if cache_key is not None:
            self.cache.put(cache_key, data, partition)
        return data

    # -- staged decode -------------------------------------------------------

    def _virtual_done(self, store: Any) -> Optional[float]:
        # the calling thread's virtual completion on a modeled store: the
        # moment the bytes it just fetched exist, which the decode stage
        # passes along as the causal floor for its compute charge. (Hedged
        # gets land on daemon threads, so the winner's completion may not
        # be visible here — the decode charge then floors at the decode
        # thread's own timeline, a benign underestimate.)
        fn = getattr(getattr(store, "latency", None), "thread_done_s", None)
        return fn() if fn is not None else None

    def _decode_timed(self, store: Any, raw: bytes,
                      partition: Optional[str],
                      ready: Optional[float]) -> bytes:
        """Decode ``raw`` with time accounting; unframed bytes pass through.

        Real decode seconds are bumped into the stats and — on a modeled
        store — charged onto the virtual timeline via ``charge_compute``
        (starting no earlier than ``ready``, the fetch's virtual
        completion), so ``elapsed_s`` reports the pipelined makespan while
        ``io_elapsed_s`` keeps the pure wire time.
        """
        if not is_framed(raw):
            return raw
        t0 = time.perf_counter()
        overlapped = self._inflight > 0
        data = self._decode_wire(store, raw, partition=partition)
        d = time.perf_counter() - t0
        overlapped = overlapped or self._inflight > 0
        self.stats.bump(decode_s=d, decode_overlap_s=d if overlapped else 0.0)
        lm = getattr(store, "latency", None)
        if lm is not None and getattr(lm, "virtual_clock", False):
            charge = getattr(lm, "charge_compute", None)
            if charge is not None:
                charge(d, not_before=ready)
        return data

    def _submit_miss(self, store: Any, key: str,
                     cache_key: Optional[Tuple[int, str]],
                     partition: Optional[str]) -> Future:
        """Submit one cache-miss fetch; decode rides the staged pool."""
        if self._decode is None:
            return self._io.submit(self._fetch_miss, store, key, cache_key,
                                   partition)
        out: Future = Future()
        self._io.submit(self._wire_stage, store, key, cache_key, partition,
                        out)
        return out

    def _wire_stage(self, store: Any, key: str,
                    cache_key: Optional[Tuple[int, str]],
                    partition: Optional[str], out: Future) -> None:
        if not out.set_running_or_notify_cancel():
            return
        try:
            raw = self._get_raw(store, key)
        except BaseException as e:
            out.set_exception(e)
            return
        if not is_framed(raw):
            # nothing to decode — complete on the wire thread, no handoff
            if cache_key is not None:
                self.cache.put(cache_key, raw, partition)
            out.set_result(raw)
            return
        ready = self._virtual_done(store)
        # bounded handoff: when decoders fall behind, the fetch thread
        # blocks here instead of buffering unbounded frames
        self._decode_slots.acquire()
        self.stats.bump(decodes_offloaded=1)
        self._decode.submit(self._decode_stage, store, raw, cache_key,
                            partition, ready, out)

    def _decode_stage(self, store: Any, raw: bytes,
                      cache_key: Optional[Tuple[int, str]],
                      partition: Optional[str], ready: Optional[float],
                      out: Future) -> None:
        try:
            data = self._decode_timed(store, raw, partition, ready)
            if cache_key is not None:
                self.cache.put(cache_key, data, partition)
            out.set_result(data)
        except BaseException as e:
            out.set_exception(e)
        finally:
            self._decode_slots.release()

    # -- public fetch API ----------------------------------------------------

    def fetch(self, store: Any, key: str, *, cacheable: bool = True,
              cache_name: Optional[str] = None,
              cache_partition: Optional[str] = None) -> bytes:
        """One object get through cache + pool + hedging.

        ``cache_name`` overrides the cache key (object key by default):
        content-addressed reads pass :func:`content_cache_key` of the
        block's hash so aliased paths share one cache entry.
        ``cache_partition`` names the block-cache priority class the
        fetched (or promoted) block lands in — see :class:`BlockCache`.
        """
        ck = ((_store_token(store), cache_name or key)
              if cacheable and self.cache.capacity else None)
        if ck is not None:
            hit = self.cache.get(ck, cache_partition)
            if hit is not None:
                self.stats.bump(cache_hits=1)
                return hit
            self.stats.bump(cache_misses=1)
        return self._submit_miss(store, key, ck, cache_partition).result()

    def fetch_ordered(self, store: Any, keys: Sequence[str], *,
                      cacheable: bool = True,
                      window: Optional[int] = None,
                      cache_names: Optional[Sequence[Optional[str]]] = None,
                      cache_partition: Optional[str] = None,
                      ) -> Iterator[bytes]:
        """Fetch ``keys`` concurrently, yield results in input order.

        Submission is windowed (default ``2 * max_workers`` outstanding
        gets) so a scan over thousands of files doesn't swamp the pool
        queue or starve concurrent readers; decode of block *i* overlaps
        the in-flight fetches of blocks > *i*. Pass ``window=`` to bound
        it explicitly — the stream loader's backpressure rides on this.
        ``cache_names`` (aligned with ``keys``; None entries fall back to
        the object key) names cache entries by content hash, as in
        :meth:`fetch`. ``cache_partition`` routes every fetched block
        into that priority class of the block cache.
        """
        keys = list(keys)
        names: List[Optional[str]] = (list(cache_names) if cache_names
                                      else [None] * len(keys))
        if len(names) != len(keys):
            raise ValueError("cache_names must align with keys")
        if window is None:
            window = 2 * self.max_workers
        window = max(int(window), 2)
        pending: List[Future] = []

        def submit(i: int) -> Future:
            key = keys[i]
            ck = ((_store_token(store), names[i] or key)
                  if cacheable and self.cache.capacity else None)
            if ck is not None:
                hit = self.cache.get(ck, cache_partition)
                if hit is not None:
                    self.stats.bump(cache_hits=1)
                    f: Future = Future()
                    f.set_result(hit)
                    return f
                self.stats.bump(cache_misses=1)
            return self._submit_miss(store, key, ck, cache_partition)

        try:
            for i in range(min(window, len(keys))):
                pending.append(submit(i))
            for i in range(len(keys)):
                if i + window < len(keys):
                    pending.append(submit(i + window))
                yield pending[i].result()
        finally:
            for f in pending:
                f.cancel()

    def fetch_all(self, store: Any, keys: Sequence[str], *,
                  cacheable: bool = True) -> List[bytes]:
        """Materialized :meth:`fetch_ordered` (all blobs, input order)."""
        return list(self.fetch_ordered(store, keys, cacheable=cacheable))

    def invalidate(self, store: Any, keys: Sequence[str]) -> None:
        """Evict cached blocks for ``keys`` of ``store``.

        Data-file paths are immutable, so the cache normally never needs
        invalidation — EXCEPT when maintenance deletes the objects
        themselves: a vacuumed path must not keep serving from cache, or
        the cache masks a read that would fail against the real store.
        """
        tok = _store_token(store)
        for key in keys:
            self.cache.invalidate((tok, key))

    # -- composite work ------------------------------------------------------

    def submit(self, fn: Callable, *args: Any, **kwargs: Any) -> Future:
        """Run a composite job (may itself call ``fetch``) in the work pool."""
        return self._work.submit(fn, *args, **kwargs)

    def map(self, fn: Callable, items: Sequence[Any]) -> List[Any]:
        """Apply ``fn`` to each item concurrently; results in input order."""
        futures = [self._work.submit(fn, it) for it in items]
        return [f.result() for f in futures]

    # -- hedging -------------------------------------------------------------

    def hedged(self, fn: Callable[[], Any], *,
               hedge_after_s: Optional[float] = None,
               attempts: Optional[int] = None) -> Any:
        """Run ``fn`` with tail-latency hedging; first result wins.

        Generalizes the loader's old ad-hoc helper: attempts run on
        dedicated daemon threads (never pool workers), so hedging can never
        deadlock the I/O or work pools even under full saturation. Losing
        stragglers are abandoned — safe because reads are idempotent.
        """
        after = self.hedge_after_s if hedge_after_s is None else hedge_after_s
        n = self.hedge_attempts if attempts is None else max(1, int(attempts))
        if after is None or n <= 1:
            return fn()

        results: "queue.SimpleQueue[Tuple[int, bool, Any]]" = queue.SimpleQueue()

        def attempt(i: int) -> None:
            try:
                results.put((i, True, fn()))
            except BaseException as e:  # surfaced below
                results.put((i, False, e))

        def launch(i: int) -> None:
            t = threading.Thread(target=attempt, args=(i,), daemon=True,
                                 name=f"lakehedge-{i}")
            t.start()

        launch(0)
        launched, outstanding = 1, 1
        last_err: Optional[BaseException] = None
        while True:
            try:
                timeout = after if launched < n else None
                i, ok, val = results.get(timeout=timeout)
            except queue.Empty:
                self.stats.bump(hedges_launched=1)
                launch(launched)
                launched += 1
                outstanding += 1
                continue
            outstanding -= 1
            if ok:
                if i > 0:
                    self.stats.bump(hedges_won=1)
                return val
            last_err = val
            if outstanding == 0:
                raise last_err

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self, wait: bool = False) -> None:
        """Release pool threads. Pools spawn threads lazily (an idle
        executor holds none), but long-lived processes that churn through
        private executors should close them — or use ``with`` blocks."""
        self._work.shutdown(wait=wait)
        self._io.shutdown(wait=wait)
        if self._decode is not None:
            self._decode.shutdown(wait=wait)

    def __enter__(self) -> "ReadExecutor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(wait=False)


# -- process-wide default ----------------------------------------------------

_default_lock = threading.Lock()
_default_executor: Optional[ReadExecutor] = None


def get_default_executor() -> ReadExecutor:
    """Process-wide shared executor (lazily created)."""
    global _default_executor
    with _default_lock:
        if _default_executor is None:
            _default_executor = ReadExecutor()
        return _default_executor


def set_default_executor(executor: Optional[ReadExecutor]) -> None:
    """Swap the process-wide executor (tests / width sweeps)."""
    global _default_executor
    with _default_lock:
        _default_executor = executor
