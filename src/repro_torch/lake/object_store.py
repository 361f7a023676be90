"""Object-store abstraction underneath the delta log.

Cloud object stores (S3/GCS/ABS) are immutable key-value stores with
put / get / list / delete and (on some providers) put-if-absent. The delta
log only needs those five verbs, so the whole lake runs against this
interface. Two implementations:

* ``LocalFSObjectStore`` — keys are files under a root dir; put-if-absent is
  ``O_CREAT|O_EXCL`` (atomic on POSIX), which is how delta-on-HDFS commits.
* ``InMemoryObjectStore`` — dict-backed, with an optional latency/bandwidth
  model so benchmarks can reproduce the paper's 1 Gbps object-store setting
  on a CPU box (per-request RTT + bytes/bandwidth sleep, or virtual-clock
  accounting when ``virtual_clock=True`` so benchmarks don't actually sleep).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple


class PutIfAbsentError(Exception):
    """Raised when a conditional put loses the race (key already exists)."""


class ObjectNotFoundError(KeyError):
    """Raised by ``get``/``head`` for a key that does not exist."""


class ObjectStore:
    """Interface: immutable blobs addressed by '/'-separated string keys."""

    def put(self, key: str, data: bytes, *, if_absent: bool = False) -> None:
        """Store ``data`` at ``key``; with ``if_absent`` raise
        :class:`PutIfAbsentError` instead of overwriting (the atomic
        commit primitive)."""
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        """The blob at ``key``; raises :class:`ObjectNotFoundError`."""
        raise NotImplementedError

    def list(self, prefix: str = "") -> Iterator[str]:
        """All keys starting with ``prefix``, in sorted order."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Remove ``key``; deleting a missing key is a no-op."""
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        """Whether ``key`` exists (a HEAD probe; costs one RTT)."""
        try:
            self.head(key)
            return True
        except ObjectNotFoundError:
            return False

    def head(self, key: str) -> int:
        """Size in bytes; raises ObjectNotFoundError."""
        raise NotImplementedError


class LocalFSObjectStore(ObjectStore):
    """Keys are files under a root directory (delta-on-HDFS style)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.normpath(os.path.join(self.root, key))
        if not p.startswith(self.root):
            raise ValueError(f"key escapes root: {key!r}")
        return p

    def put(self, key: str, data: bytes, *, if_absent: bool = False) -> None:
        """Durably write ``data``; ``if_absent`` uses O_CREAT|O_EXCL
        (atomic on POSIX — the delta commit primitive)."""
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if if_absent:
            # O_EXCL gives atomic put-if-absent on POSIX — the delta commit
            # primitive. No tmp+rename: rename would clobber a racer.
            try:
                fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
            except FileExistsError as e:
                raise PutIfAbsentError(key) from e
            try:
                os.write(fd, data)
                os.fsync(fd)
            finally:
                os.close(fd)
        else:
            tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)

    def get(self, key: str) -> bytes:
        """Read the file at ``key``; raises :class:`ObjectNotFoundError`."""
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError as e:
            raise ObjectNotFoundError(key) from e

    def list(self, prefix: str = "") -> Iterator[str]:
        """Sorted keys under ``prefix`` (in-flight .tmp files hidden)."""
        base = self.root
        out = []
        for dirpath, _dirnames, filenames in os.walk(base):
            for fn in filenames:
                if fn.endswith(".tmp") or ".tmp." in fn:
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), base)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return iter(sorted(out))

    def delete(self, key: str) -> None:
        """Remove the file at ``key``; missing keys are a no-op."""
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def head(self, key: str) -> int:
        """Size in bytes; raises :class:`ObjectNotFoundError`."""
        try:
            return os.stat(self._path(key)).st_size
        except FileNotFoundError as e:
            raise ObjectNotFoundError(key) from e


@dataclass
class LatencyModel:
    """Paper setting: 1 Gbps network, object-store request overhead.

    ``rtt_s`` is charged per request; payload bytes are charged at
    ``bandwidth_bps``. With ``virtual_clock`` the cost is accumulated in
    ``elapsed_s`` instead of sleeping, so benchmarks measure modeled I/O time
    plus real encode/decode CPU time separately.

    ``parallelism`` models concurrent object-store channels (the read
    executor's width) and ``elapsed_s`` becomes the **makespan**. Causality
    is respected via the issuing thread: a request starts in virtual time
    no earlier than (a) its thread's previous request finished — a serial
    caller gets serial time regardless of the configured width — and (b)
    the least-loaded channel frees up. Only requests issued by genuinely
    concurrent threads (the executor's pool) overlap. Payload bytes still
    contend for the one shared link, so the makespan never beats
    ``total_bytes / bandwidth``. ``serial_s`` keeps the width-1 sum so
    benchmarks can report both without re-running.
    """

    rtt_s: float = 0.010
    bandwidth_bps: float = 1e9  # 1 Gbps, as in the paper's testbed
    virtual_clock: bool = True
    parallelism: int = 1
    # virtual-clock mode only: hold the calling thread for cost*scale real
    # seconds. In-memory gets return instantly, so without this one pool
    # worker can drain the whole fetch queue and the per-thread causality
    # rule under-models achievable parallelism; a small occupancy makes
    # thread scheduling mirror modeled request durations.
    occupancy_scale: float = 0.0
    elapsed_s: float = 0.0
    serial_s: float = 0.0
    compute_s: float = 0.0
    io_elapsed_s: float = 0.0
    requests: int = 0
    bytes_moved: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _channels: list = field(default_factory=list, repr=False)
    _thread_done: dict = field(default_factory=dict, repr=False)
    _thread_latency: dict = field(default_factory=dict, repr=False)
    _transfer_s: float = field(default=0.0, repr=False)

    def charge(self, nbytes: int) -> None:
        """Account one request moving ``nbytes`` payload bytes.

        Charged at the size the store actually moves — for
        frame-compressed part files that is the *compressed* size, which
        is how benchmarks see the bandwidth win honestly."""
        transfer = (nbytes * 8.0) / self.bandwidth_bps
        cost = self.rtt_s + transfer
        tid = threading.get_ident()
        with self._lock:
            self.requests += 1
            self.bytes_moved += nbytes
            self.serial_s += cost
            if self.parallelism <= 1:
                self.elapsed_s += cost
                self.io_elapsed_s += cost
                self._thread_latency[tid] = cost
                self._thread_done[tid] = self.elapsed_s
            else:
                if len(self._channels) != self.parallelism:
                    self._channels = [0.0] * self.parallelism
                i = min(range(self.parallelism), key=self._channels.__getitem__)
                prev = self._thread_done.get(tid)
                start = max(self._channels[i], prev or 0.0)
                done = start + cost
                # request latency as the caller experiences it: from the
                # moment this thread became free (its previous request's
                # completion — or now, for its first request) until this
                # one finishes. Queueing behind busy channels is latency;
                # the thread's own earlier work is not.
                ready = prev if prev is not None else self._channels[i]
                self._thread_latency[tid] = done - ready
                self._channels[i] = done
                self._thread_done[tid] = done
                self._transfer_s += transfer
                # channels hold pure wire time; compute charges (decode
                # stage) only ever push elapsed_s past io_elapsed_s
                self.io_elapsed_s = max(max(self._channels), self._transfer_s)
                self.elapsed_s = max(self.elapsed_s, self.io_elapsed_s)
        if not self.virtual_clock:
            time.sleep(cost)
        elif self.occupancy_scale > 0.0:
            time.sleep(cost * self.occupancy_scale)

    def charge_compute(self, seconds: float, *,
                       not_before: Optional[float] = None) -> None:
        """Charge real CPU seconds (frame decode) onto the virtual timeline.

        The calling thread's virtual clock advances by ``seconds`` starting
        at max(its previous virtual completion, ``not_before``) —
        ``not_before`` carries the producing fetch's virtual completion, so
        decode causally follows the bytes it decodes while overlapping
        other threads' wire time. Compute is off-channel: it never occupies
        an object-store channel, so ``io_elapsed_s`` stays the pure-I/O
        makespan and ``elapsed_s`` becomes the pipelined makespan.
        """
        s = max(0.0, float(seconds))
        tid = threading.get_ident()
        with self._lock:
            self.compute_s += s
            self.serial_s += s
            if self.parallelism <= 1:
                self.elapsed_s += s
                self._thread_done[tid] = self.elapsed_s
                return
            start = max(self._thread_done.get(tid, 0.0), not_before or 0.0)
            done = start + s
            self._thread_done[tid] = done
            if done > self.elapsed_s:
                self.elapsed_s = done

    def thread_done_s(self) -> Optional[float]:
        """The calling thread's virtual completion time (None if it has
        not been charged yet, or in real-sleep mode). The decode stage
        reads this on the fetch thread to timestamp when a frame's bytes
        exist in virtual time."""
        if not self.virtual_clock:
            return None
        with self._lock:
            return self._thread_done.get(threading.get_ident())

    def request_latency_s(self) -> Optional[float]:
        """Virtual-clock latency of the calling thread's last request.

        Read by the :class:`~repro_torch.lake.io.ReadExecutor` right after a
        ``get`` returns, so latency histograms on modeled stores record
        deterministic virtual durations instead of wall-clock noise.
        Returns None if this thread has not issued a request (or in
        real-sleep mode, where wall clock is already the truth)."""
        if not self.virtual_clock:
            return None
        with self._lock:
            return self._thread_latency.get(threading.get_ident())

    def reset(self) -> None:
        """Zero the accumulated time/request/byte accounting."""
        with self._lock:
            self.elapsed_s = 0.0
            self.serial_s = 0.0
            self.compute_s = 0.0
            self.io_elapsed_s = 0.0
            self.requests = 0
            self.bytes_moved = 0
            self._channels = []
            self._thread_done = {}
            self._thread_latency = {}
            self._transfer_s = 0.0


class InMemoryObjectStore(ObjectStore):
    """Dict-backed store with an optional modeled-latency account."""

    def __init__(self, latency: Optional[LatencyModel] = None,
                 fail_after_puts: Optional[int] = None):
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.latency = latency
        # Fault-injection hook: raise IOError after N puts (tests crash-mid-
        # checkpoint recovery).
        self.fail_after_puts = fail_after_puts
        self._puts = 0

    def put(self, key: str, data: bytes, *, if_absent: bool = False) -> None:
        """Store ``data`` (charging modeled latency); ``if_absent``
        raises :class:`PutIfAbsentError` when the key exists."""
        if self.latency:
            self.latency.charge(len(data))
        with self._lock:
            if self.fail_after_puts is not None and self._puts >= self.fail_after_puts:
                raise IOError(f"injected fault after {self._puts} puts")
            if if_absent and key in self._data:
                raise PutIfAbsentError(key)
            self._data[key] = bytes(data)
            self._puts += 1

    def get(self, key: str) -> bytes:
        """The stored blob (charging modeled latency for its size)."""
        with self._lock:
            if key not in self._data:
                raise ObjectNotFoundError(key)
            data = self._data[key]
        if self.latency:
            self.latency.charge(len(data))
        return data

    def list(self, prefix: str = "") -> Iterator[str]:
        """Sorted keys under ``prefix`` (one modeled list request)."""
        if self.latency:
            self.latency.charge(0)
        with self._lock:
            keys = sorted(k for k in self._data if k.startswith(prefix))
        return iter(keys)

    def delete(self, key: str) -> None:
        """Drop ``key``; missing keys are a no-op."""
        with self._lock:
            self._data.pop(key, None)

    def head(self, key: str) -> int:
        """Size in bytes; raises :class:`ObjectNotFoundError`."""
        # a HEAD is a real round-trip on S3/GCS — charge the RTT (0 bytes)
        # so latest_version() probing shows up in modeled I/O accounting
        if self.latency:
            self.latency.charge(0)
        with self._lock:
            if key not in self._data:
                raise ObjectNotFoundError(key)
            return len(self._data[key])


class InjectedFault(IOError):
    """The error a firing :class:`FaultRule` raises (distinguishable from
    real I/O failures in test assertions)."""


@dataclass
class FaultRule:
    """One deterministic failure in a :class:`FaultInjectingObjectStore`.

    Fires on matching operations number ``nth`` .. ``nth + count - 1``
    (1-based, counted per rule across the wrapper's lifetime). ``key``
    is a substring filter on the object key (None matches every key; for
    ``list`` it matches the prefix argument). Actions:

    * ``"raise"`` — raise :class:`InjectedFault` *before* the operation
      has any effect (a request that never reached the store);
    * ``"raise-after"`` — apply the operation fully, then raise (a lost
      acknowledgement: the classic ambiguous-commit failure);
    * ``"partial"`` — ``put`` only: store the first
      ``int(len(data) * partial_frac)`` bytes, then raise (a torn upload).
      Conditional puts (``if_absent=True``) are the store's atomic commit
      primitive — real object stores never tear them — so a partial rule
      on one degrades to ``"raise"`` (no effect);
    * ``"notfound"`` — ``get``/``head`` raise
      :class:`ObjectNotFoundError` despite the key existing (HEAD-after-PUT
      eventual consistency);
    * ``"latency"`` — charge ``latency_s`` extra seconds (virtual when the
      inner store has a virtual-clock :class:`LatencyModel`, a real sleep
      otherwise), then proceed normally.
    """

    op: str                       # "put" | "get" | "head" | "delete" | "list"
    action: str = "raise"
    key: Optional[str] = None
    nth: int = 1
    count: int = 1
    latency_s: float = 0.0
    partial_frac: float = 0.5
    seen: int = field(default=0, repr=False)   # matching ops observed so far

    def matches(self, op: str, key: str) -> bool:
        return op == self.op and (self.key is None or self.key in key)

    @property
    def exhausted(self) -> bool:
        """Whether this rule can never fire again."""
        return self.seen >= self.nth + self.count - 1


class FaultInjectingObjectStore(ObjectStore):
    """Wraps any :class:`ObjectStore` with deterministic failure schedules.

    The reusable crash-testing harness: tests hand it a list of
    :class:`FaultRule` and drive the writer under test until a rule fires —
    "kill the writer after the 3rd data put", "lose the ack of the commit
    put", "tear the 2nd upload halfway". Every operation (faulted or not)
    is appended to ``op_log`` as ``(op, key)`` so assertions can reconstruct
    exactly what reached the store.

    Unknown attributes delegate to the wrapped store (``latency``, ``root``,
    ``_data``...), and the io-cache identity token is shared with the inner
    instance, so upload guards, leases, and block-cache entries key to the
    same physical store whether a component holds the wrapper or the
    wrapped instance.
    """

    def __init__(self, inner: ObjectStore,
                 rules: Optional[List[FaultRule]] = None):
        self.inner = inner
        self.rules: List[FaultRule] = list(rules or ())
        self.op_log: List[Tuple[str, str]] = []
        self.injected = 0
        self._fault_lock = threading.Lock()

    def __getattr__(self, name: str):
        if name == "inner":
            raise AttributeError(name)
        if name == "_io_cache_token":
            # force the inner store to own the token, then mirror it: both
            # handles must resolve to one store_scope / lease scope
            from .io import _store_token
            tok = _store_token(self.inner)
            self._io_cache_token = tok
            return tok
        return getattr(self.inner, name)

    def add_rule(self, rule: FaultRule) -> FaultRule:
        """Arm one more rule (occurrence counting starts now)."""
        with self._fault_lock:
            self.rules.append(rule)
        return rule

    def clear_rules(self) -> None:
        """Disarm every rule (the op log and counters are kept)."""
        with self._fault_lock:
            self.rules = []

    def _check(self, op: str, key: str) -> Optional[FaultRule]:
        """Record the op; return the first rule due to fire on it."""
        with self._fault_lock:
            self.op_log.append((op, key))
            firing = None
            for rule in self.rules:
                if not rule.matches(op, key):
                    continue
                rule.seen += 1
                if firing is None and \
                        rule.nth <= rule.seen < rule.nth + rule.count:
                    firing = rule
            if firing is not None:
                self.injected += 1
            return firing

    def _spike(self, seconds: float) -> None:
        lm = getattr(self.inner, "latency", None)
        if lm is not None and getattr(lm, "virtual_clock", False):
            # model the spike as extra wire time: one request whose
            # transfer takes exactly `seconds` on top of the RTT
            lm.charge(int(seconds * lm.bandwidth_bps / 8))
        else:
            time.sleep(seconds)

    def put(self, key: str, data: bytes, *, if_absent: bool = False) -> None:
        rule = self._check("put", key)
        if rule is not None:
            if rule.action == "raise-after":
                self.inner.put(key, data, if_absent=if_absent)
                raise InjectedFault(f"lost ack of put {key!r}")
            if rule.action == "partial" and not if_absent:
                self.inner.put(key, data[:int(len(data) * rule.partial_frac)])
                raise InjectedFault(f"torn put {key!r}")
            if rule.action == "latency":
                self._spike(rule.latency_s)
            else:
                raise InjectedFault(f"injected fault on put {key!r}")
        self.inner.put(key, data, if_absent=if_absent)

    def get(self, key: str) -> bytes:
        rule = self._check("get", key)
        if rule is not None:
            if rule.action == "notfound":
                raise ObjectNotFoundError(key)
            if rule.action == "latency":
                self._spike(rule.latency_s)
            else:
                raise InjectedFault(f"injected fault on get {key!r}")
        return self.inner.get(key)

    def head(self, key: str) -> int:
        rule = self._check("head", key)
        if rule is not None:
            if rule.action == "notfound":
                raise ObjectNotFoundError(key)
            if rule.action == "latency":
                self._spike(rule.latency_s)
            else:
                raise InjectedFault(f"injected fault on head {key!r}")
        return self.inner.head(key)

    def list(self, prefix: str = "") -> Iterator[str]:
        rule = self._check("list", prefix)
        if rule is not None:
            if rule.action == "latency":
                self._spike(rule.latency_s)
            else:
                raise InjectedFault(f"injected fault on list {prefix!r}")
        return self.inner.list(prefix)

    def delete(self, key: str) -> None:
        rule = self._check("delete", key)
        if rule is not None:
            if rule.action == "raise-after":
                self.inner.delete(key)
                raise InjectedFault(f"lost ack of delete {key!r}")
            if rule.action == "latency":
                self._spike(rule.latency_s)
            else:
                raise InjectedFault(f"injected fault on delete {key!r}")
        self.inner.delete(key)
