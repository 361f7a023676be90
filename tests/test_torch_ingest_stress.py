"""Ingest racing compact and vacuum on the port's store.

The port's counterpart of ``tests/test_ingest.py``'s concurrency stress
test: threaded ``IngestWriter``s and ``StreamLoader`` readers while the
main thread compacts and vacuums, then no row lost or duplicated. A
deterministic case lands a writer's commit between compact's plan and its
fenced commit on every attempt, so compact loses more races than it
retries: it must report that it did nothing, not raise into the
maintenance loop.
"""

from __future__ import annotations

import inspect
import threading

import numpy as np
import pytest

from repro_torch.core.store import DeltaTensorStore
from repro_torch.data.stream import StreamLoader
from repro_torch.lake import DeltaTable, InMemoryObjectStore, LatencyModel

WIDTH = 4


def tag(i, t):
    """Writer ``i``'s row ``t``: constant across the row (a torn row would
    mix values), unique across writers."""
    return np.full((1, WIDTH), i * 1_000_000 + t, dtype=np.int64)


def assert_rows_exactly_once(store, tids, counts):
    for i, t in enumerate(tids):
        got = store.get(t)
        assert got.shape == (counts[t], WIDTH), t
        want = np.arange(counts[t], dtype=np.int64) + i * 1_000_000
        assert np.array_equal(np.sort(got[:, 0]), want), t


def test_concurrent_ingest_readers_and_compact_stress():
    """4 threaded ingest writers + 2 StreamLoader readers + compact/vacuum in
    a loop on a 4-shard store, for 200 virtual-clock seconds: zero lost
    rows, zero reader errors, every writer's conflict retried."""
    lm = LatencyModel(rtt_s=0.5, virtual_clock=True, parallelism=4,
                      occupancy_scale=0.001)
    store = DeltaTensorStore(InMemoryObjectStore(latency=lm), "ts", shards=4,
                             device="cpu")
    tids = [f"w{i}" for i in range(4)]
    counts = {t: 0 for t in tids}
    for i, t in enumerate(tids):
        with store.ingest(t, watermark_rows=8) as w:
            for _ in range(8):
                w.append_rows(tag(i, counts[t]))
                counts[t] += 1

    stop = threading.Event()
    errors = []
    batches = [0]

    def writer(i):
        t = tids[i]
        try:
            w = store.ingest(t, watermark_rows=8)
            flushes = 0
            while lm.elapsed_s < 200.0 and flushes < 12:
                for _ in range(8):
                    w.append_rows(tag(i, counts[t]))
                    counts[t] += 1
                flushes += 1
            w.close()
        except Exception as e:  # pragma: no cover - the assertion payload
            errors.append(("writer", i, e))

    def reader(j):
        try:
            loader = StreamLoader(store, tids, batch_size=8, epochs=1,
                                  seed=j, clock=lambda: lm.elapsed_s)
            while not stop.is_set():
                for b in loader:
                    data = np.asarray(b["data"])
                    assert (data == data[:, :1]).all()
                    batches[0] += 1
                    if stop.is_set():
                        break
                loader = loader.reopen()
            loader.close()
        except Exception as e:  # pragma: no cover - the assertion payload
            errors.append(("reader", j, e))

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    threads += [threading.Thread(target=reader, args=(j,)) for j in range(2)]
    for th in threads:
        th.start()
    passes = 0
    try:
        while any(th.is_alive() for th in threads[:4]):
            store.compact()
            store.vacuum()
            passes += 1
            for th in threads[:4]:
                th.join(timeout=0.05)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
    assert not errors, errors
    assert batches[0] > 0 and passes > 0
    assert_rows_exactly_once(store, tids, counts)
    assert store.commit_stats["conflicts"] == store.commit_stats["retries"]
    store.vacuum()
    for t in tids:
        assert store.get(t).shape[0] == counts[t]


def racing_commit(monkeypatch, table, writer, every_attempt=True):
    """Make ``writer()`` land a commit on ``table`` between each compact plan
    and its fenced commit (only the first one unless ``every_attempt``).
    Returns the list of compact commit attempts seen."""
    attempts = []
    real = table.commit_adds

    def commit_adds(adds, *, op="WRITE", **kw):
        if op == "OPTIMIZE":
            attempts.append(kw.get("expected_version"))
            if every_attempt or len(attempts) == 1:
                writer()
        return real(adds, op=op, **kw)

    monkeypatch.setattr(table, "commit_adds", commit_adds)
    return attempts


DEFAULT_RETRIES = inspect.signature(
    DeltaTable.compact).parameters["max_retries"].default


@pytest.mark.parametrize("every_attempt,max_retries", [
    (True, None), (False, None), (True, 0)],
    ids=["loses-every-race", "wins-a-retry", "no-retries"])
def test_compact_losing_races_to_a_writer_does_not_raise(
        monkeypatch, every_attempt, max_retries):
    """A writer commits between compact's plan and its commit on each of
    compact's attempts: compact gives up after ``max_retries`` re-plans and
    returns a falsy result that counts the lost races, instead of raising
    ``CommitConflict`` into the maintenance loop; each row is still there
    exactly once, and a later pass compacts. When only the first attempt
    loses, compact re-plans on the writer's snapshot and commits."""
    store = DeltaTensorStore(InMemoryObjectStore(), "ts", device="cpu")
    tids, counts = ["w0"], {"w0": 0}
    w = store.ingest("w0", watermark_rows=4)

    def append(n=4):
        for _ in range(n):
            w.append_rows(tag(0, counts["w0"]))
            counts["w0"] += 1

    append(12)                          # three files: compact has work
    w.flush()
    table = store.tables[0]
    attempts = racing_commit(monkeypatch, table, append, every_attempt)
    if max_retries is None:             # the maintenance path
        res, retries = store.compact()[0], DEFAULT_RETRIES
    else:
        res, retries = table.compact(max_retries=max_retries), max_retries
    if every_attempt:
        assert len(attempts) == retries + 1
        assert not res and res.version is None
        assert res.lost_races == retries + 1
    else:
        assert len(attempts) == 2 and attempts[1] > attempts[0]
        assert res and res.lost_races == 1 and res.version is not None
    w.flush()
    assert_rows_exactly_once(store, tids, counts)
    monkeypatch.undo()
    again = store.compact()[0]
    assert again.lost_races == 0
    # the pass that lost every race left its work to this one; a pass that
    # won its retry left one data file and nothing to do
    assert bool(again) == every_attempt
    w.close()
    store.vacuum(keep_versions=1)
    assert_rows_exactly_once(store, tids, counts)
    assert len(store.tables[0].files()) == 2   # the header and one data file
