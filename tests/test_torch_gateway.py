"""The port's gateway admission layer, ModelRepo handles and partitioned
block cache: the scenarios of ``tests/test_gateway.py`` on
``repro_torch.serve`` over a CPU store (``device="cpu"``). Weights are
torch tensors made from numpy; loads land them on the store's device.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import DeltaTensorStore
from repro_torch.lake import InMemoryObjectStore, ReadExecutor
from repro_torch.lake.io import BlockCache
from repro_torch.serve import (Gateway, RetryAfter, TenantPolicy, jain_index,
                               load_weights, save_weights)

CPU = "cpu"


def _params(seed=0, leaves=3, shape=(16, 32)):
    rng = np.random.default_rng(seed)
    return {f"layer{i}": torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)) for i in range(leaves)}


def _equal(a, b):
    assert isinstance(a, torch.Tensor) and a.device.type == CPU
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _store(**io_kw):
    return DeltaTensorStore(InMemoryObjectStore(), "weights",
                            io=ReadExecutor(max_workers=4, **io_kw),
                            device=CPU)


class _GatedStore(InMemoryObjectStore):
    """Object store whose data-file gets can be held at a barrier.

    Log/commit reads pass through (catalog resolution and saves must not
    deadlock); only chunk-data gets block, so a test can freeze a weight
    load mid-flight, land a re-save, then release the load.
    """

    def __init__(self):
        super().__init__()
        self.release = threading.Event()
        self.release.set()
        self.entered = threading.Event()

    def get(self, key, *args, **kwargs):
        if "/part-" in key and not self.release.is_set():
            self.entered.set()
            assert self.release.wait(10), "gated store never released"
        return super().get(key, *args, **kwargs)


# -- ModelRepo handle API -----------------------------------------------------

def test_model_repo_roundtrip_and_pinning():
    store = _store()
    params = _params(1)
    with store.models("m") as repo:
        assert not repo.exists()
        repo.save(params)
        assert repo.exists()
        assert sorted(repo.leaf_ids()) == [f"m/layer{i}" for i in range(3)]
        v1 = repo.version
        loaded = repo.load(params)
        for k in params:
            _equal(loaded[k], params[k])

        # a re-save through ANOTHER handle must not move this repo's pin
        bumped = {k: v + 1 for k, v in params.items()}
        with store.models("m") as w:
            w.save(bumped)
        assert repo.version == v1
        stale = repo.load(params)
        _equal(stale["layer0"], params["layer0"])
        repo.refresh()
        assert repo.version != v1
        _equal(repo.load(params)["layer0"],
                                      bumped["layer0"])
    assert repo.closed


def test_model_repo_variant_delta_roundtrip():
    store = _store()
    base = _params(2)
    with store.models("base") as repo:
        repo.save(base)
        ft = {k: v.clone() for k, v in base.items()}
        ft["layer1"] = ft["layer1"] * 2.0
        with repo.open_variant("ft") as var:
            assert var.prefix == "base~ft" and var.base is repo
            var.save(ft)
            got = var.load(base)
        for k in ft:
            _equal(got[k], ft[k])
        # the variant reads back through a fresh handle too (no base repo)
        with store.models("base~ft") as again:
            _equal(again.load(base)["layer1"],
                                          ft["layer1"])


def test_model_repo_empty_store_load_raises():
    store = _store()
    with store.models("nothing") as repo:
        with pytest.raises(KeyError):
            repo.load(_params())


def test_weight_shims_behavior_identical_and_deprecated():
    """save_weights/load_weights == ModelRepo.save/load, plus a warning."""
    params = _params(3)
    store_a, store_b = _store(), _store()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        shim_tids = save_weights(store_a, params, prefix="w")
        shim_loaded = load_weights(store_a, params, prefix="w")
    assert any(issubclass(w.category, DeprecationWarning) for w in rec)

    with store_b.models("w") as repo:
        repo_tids = repo.save(params)
        repo_loaded = repo.load(params)
    assert sorted(shim_tids) == sorted(repo_tids)
    for k in params:
        _equal(shim_loaded[k], repo_loaded[k])


def test_load_weights_threads_io_through():
    """The io= override must be the executor that does the fetching."""
    store = _store()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        save_weights(store, _params(4), prefix="w")
        other = ReadExecutor(max_workers=2)
        before = other.stats.gets
        load_weights(store, _params(4), prefix="w", io=other)
        assert other.stats.gets > before  # historically silently ignored


# -- partitioned block cache --------------------------------------------------

def test_cache_partition_budgets_under_concurrent_eviction():
    cache = BlockCache(capacity_bytes=4096)
    cache.add_partition("hot", 2048, pinned=True)
    hot_keys = [(1, f"hot{i}") for i in range(4)]
    for k in hot_keys:
        cache.put(k, b"h" * 512, partition="hot")

    stop = threading.Event()

    def churn(tid):
        i = 0
        while not stop.is_set():
            cache.put((tid, f"blk{i % 64}"), b"d" * 256)
            cache.get((tid, f"blk{(i * 7) % 64}"))
            i += 1

    threads = [threading.Thread(target=churn, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    stop.set()
    for t in threads:
        t.join()

    parts = cache.partitions()
    assert parts["default"]["nbytes"] <= 4096
    assert parts["default"]["evictions"] > 0
    # the pinned class never lost a resident to the churn next door
    assert parts["hot"]["evictions"] == 0
    for k in hot_keys:
        assert cache.get(k) == b"h" * 512


def test_cache_pinned_partition_rejects_overflow_and_never_demotes():
    cache = BlockCache(capacity_bytes=4096)
    cache.add_partition("hot", 1024, pinned=True)
    cache.put((1, "a"), b"x" * 600, partition="hot")
    cache.put((1, "b"), b"y" * 600, partition="hot")   # over budget: rejected
    parts = cache.partitions()
    assert parts["hot"]["blocks"] == 1 and parts["hot"]["evictions"] == 0
    assert cache.get((1, "b")) is None

    # a default-class reader is served in place; the block stays pinned
    assert cache.get((1, "a"), partition="default") == b"x" * 600
    assert cache.partitions()["hot"]["blocks"] == 1
    # but an unpinned block IS promoted into the class a reader names
    cache.put((1, "c"), b"z" * 100)
    assert cache.get((1, "c"), partition="hot") == b"z" * 100
    assert cache.partitions()["hot"]["blocks"] == 2


def test_read_many_routes_blocks_into_named_partition():
    store = _store(cache_bytes=1 << 20)
    store.io.cache.add_partition("hot", 1 << 20)
    with store.models("m") as repo:
        repo.save(_params(5))
        repo.load(_params(5), cache_partition="hot")
    parts = store.io.cache.partitions()
    assert parts["hot"]["blocks"] > 0
    assert parts["hot"]["nbytes"] > 0


# -- gateway: coalescing ------------------------------------------------------

def test_coalesced_coldstart_byte_identical_across_mid_load_resave():
    obj = _GatedStore()
    store = DeltaTensorStore(obj, "weights", io=ReadExecutor(max_workers=4),
                             device=CPU)
    params = _params(6)
    with store.models("m") as repo:
        repo.save(params)

    with Gateway(store, max_inflight=4) as gw:
        obj.release.clear()
        f1 = gw.load_model("a", "m", params)
        assert obj.entered.wait(10)       # flight is mid-load, frozen
        f2 = gw.load_model("b", "m", params)   # joins the same flight
        assert f2 is f1

        # re-save lands while the flight is frozen mid-load
        bumped = {k: v + 1 for k, v in params.items()}
        with store.models("m") as w:
            w.save(bumped)

        obj.release.set()
        t1, t2 = f1.result(30), f2.result(30)
        stats = gw.stats()
        # both waiters: byte-identical trees of the ORIGINAL generation
        for k in params:
            _equal(t1[k], t2[k])
            _equal(t1[k], params[k])
        assert stats["flights_created"] == 1
        assert stats["coalesced_hits"] == 1

        # a requester arriving after the re-save keys a fresh flight
        t3 = gw.load_model("c", "m", params).result(30)
        _equal(t3["layer0"], bumped["layer0"])
        assert gw.stats()["flights_created"] == 2


def test_coalescing_fetches_once_for_n_tenants():
    store = _store()
    params = _params(7)
    with store.models("m") as repo:
        repo.save(params)
    solo = store.io.stats.gets

    with Gateway(store, max_inflight=8) as gw:
        before = store.io.stats.gets
        futs = [gw.load_model(f"t{i}", "m", params) for i in range(6)]
        trees = [f.result(30) for f in futs]
        gets = store.io.stats.gets - before
        assert gw.stats()["coalesced_hits"] == 5
    assert gets <= solo + len(params)  # ~one load's worth, not six
    for t in trees:
        _equal(t["layer0"], params["layer0"])


# -- gateway: quotas, fairness, shedding, lifecycle ---------------------------

def test_quota_exhaustion_rejects_instead_of_deadlocking():
    store = _store()
    with store.models("m") as repo:
        repo.save(_params(8))
    release = threading.Event()
    with Gateway(store, max_inflight=2) as gw:
        gw.register("flood", TenantPolicy(max_inflight=1, queue_limit=3))
        accepted = [gw.submit("flood", lambda: release.wait(10))
                    for _ in range(4)]  # 1 inflight + 3 queued
        rejections = []
        for _ in range(5):
            with pytest.raises(RetryAfter) as exc:
                gw.submit("flood", lambda: None)
            rejections.append(exc.value)
        assert all(r.retry_after_s > 0 for r in rejections)
        release.set()
        for f in accepted:                     # nothing deadlocks
            assert f.result(10) is True
        stats = gw.tenant_stats()["flood"]
        assert stats["rejected"] == 5 and stats["completed"] == 4


def test_weighted_fair_queueing_dispatch_shares():
    """With one slot, a weight-3 tenant drains ~3x faster than weight-1."""
    store = _store()
    order = []
    hold = threading.Event()
    with Gateway(store, max_inflight=1) as gw:
        gw.register("light", TenantPolicy(weight=1.0, max_inflight=1))
        gw.register("heavy", TenantPolicy(weight=3.0, max_inflight=1))
        blocker = gw.submit("light", lambda: hold.wait(10))
        futs = [gw.submit("light", lambda i=i: order.append(("light", i)))
                for i in range(4)]
        futs += [gw.submit("heavy", lambda i=i: order.append(("heavy", i)))
                 for i in range(4)]
        hold.set()
        for f in futs:
            f.result(10)
    # among the first four dispatched after the blocker, the weight-3
    # tenant got at least three slots (FIFO would give it at most zero)
    first4 = [t for t, _ in order[:4]]
    assert first4.count("heavy") >= 3
    # per-tenant order stayed FIFO
    assert [i for t, i in order if t == "heavy"] == [0, 1, 2, 3]
    assert [i for t, i in order if t == "light"] == [0, 1, 2, 3]


def test_jain_index():
    assert jain_index([1, 1, 1, 1]) == pytest.approx(1.0)
    assert jain_index([1, 0, 0, 0]) == pytest.approx(0.25)
    assert jain_index([]) is None
    assert jain_index([0, 0]) == pytest.approx(1.0)


def test_slo_report_and_latency_histograms():
    store = _store()
    with store.models("m") as repo:
        repo.save(_params(9))
    with Gateway(store, max_inflight=2) as gw:
        gw.register("t", TenantPolicy(p99_target_s=60.0))
        for _ in range(5):
            gw.read("t", "m/layer0").result(10)
        slo = gw.slo_report()["t"]
        assert slo["p99_s"] is not None and slo["target_s"] == 60.0
        assert slo["met"] is True
        assert slo["hedge_s"] == pytest.approx(30.0)  # derived: target / 2
        assert gw.tenant_stats()["t"]["latency"]["count"] == 5


def test_gateway_lifecycle_close_cancels_queued():
    store = _store()
    hold = threading.Event()
    gw = Gateway(store, max_inflight=1)
    running = gw.submit("t", lambda: hold.wait(10))
    queued = gw.submit("t", lambda: "never")
    gw.close()
    assert gw.closed
    with pytest.raises(RetryAfter):
        queued.result(10)
    with pytest.raises(RuntimeError):
        gw.submit("t", lambda: None)
    hold.set()
    assert running.result(10) is True   # in-flight work still completes
    gw.close()                          # idempotent


def test_serve_engine_lifecycle_owns_repo():
    store = _store()
    params = _params(10)
    with store.models("m") as writer:
        writer.save(params)
    repo = store.models("m")

    from repro_torch.models import get_arch
    from repro_torch.serve import Request, ServeEngine
    cfg = get_arch("granite-3-8b").reduced()
    with ServeEngine(params, cfg, n_slots=1, max_len=16, repo=repo) as eng:
        assert not eng.closed and not repo.closed
    assert eng.closed and repo.closed
    with pytest.raises(RuntimeError):
        eng.submit(Request(rid=0, prompt=np.zeros(2, np.int32)))


def test_load_model_lands_on_the_device_and_keys_flights_by_it():
    """``device=`` passes through to ModelRepo.load; None means the
    store's device, so it joins an explicit request for that device."""
    obj = _GatedStore()
    store = DeltaTensorStore(obj, "weights", io=ReadExecutor(max_workers=4),
                             device=CPU)
    params = _params(11)
    with store.models("m") as repo:
        repo.save(params)
    with Gateway(store, max_inflight=4) as gw:
        obj.release.clear()
        f1 = gw.load_model("a", "m", params, device=CPU)
        assert obj.entered.wait(10)
        f2 = gw.load_model("b", "m", params)
        assert f2 is f1
        obj.release.set()
        tree = f1.result(30)
    for k in params:
        _equal(tree[k], params[k])
