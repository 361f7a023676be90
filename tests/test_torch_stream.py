"""The port's training feed (``repro_torch.data``) against the JAX package.

``StreamLoader``, the ``FTSFLoader`` shim, ``write_token_dataset`` and
``IngestWriter`` of the port, run on the CPU (``device="cpu"`` for port
stores), held to the reference's loaders over the same tables: the same
sample ids per step and byte-identical batches. Tables written by either
package's ingest writer are read by the other. Device batches are checked
on the CPU device here; on the card ``chip_smoke.py`` streams an epoch to
CUDA and holds it to the host loader. One crash seam of ingest runs through
the port's ``FaultInjectingObjectStore``, with fixed fault rules and no
clock.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.lake as jlake
from repro.data.pipeline import FTSFLoader as JFTSFLoader
from repro.data.stream import StreamLoader as JStreamLoader
from repro_torch.core import DeltaTensorStore
from repro_torch.data.pipeline import FTSFLoader, write_token_dataset
from repro_torch.data.stream import StreamLoader
from repro_torch.data.synthetic import token_stream
from repro_torch.lake import (FaultInjectingObjectStore, FaultRule,
                              InjectedFault, InMemoryObjectStore,
                              LocalFSObjectStore, set_unshuffle_kernel)

from .test_torch_kernels import as_numpy, assert_same_bytes

CPU = "cpu"


@pytest.fixture(autouse=True)
def _restore_unshuffle_hook():
    yield
    set_unshuffle_kernel(None)


def port_store(root=None, **kw):
    obj = LocalFSObjectStore(str(root)) if root else InMemoryObjectStore()
    return DeltaTensorStore(obj, "ts", device=CPU, **kw)


def ref_store(root=None, **kw):
    obj = jlake.LocalFSObjectStore(str(root)) if root else jlake.InMemoryObjectStore()
    return jcore.DeltaTensorStore(obj, "ts", **kw)


def rows(lo, hi, width=6, dtype=np.int32):
    """Self-describing sample rows: row i holds i*width..i*width+width-1."""
    return np.arange(lo * width, hi * width).astype(dtype).reshape(-1, width)


def collect(loader):
    return [(b["epoch"], b["step"], np.array(b["samples"]), b["data"])
            for b in loader]


def assert_same_stream(got, want):
    assert len(got) == len(want) and got
    for (eg, sg, rg, dg), (ew, sw, rw, dw) in zip(got, want):
        assert (eg, sg) == (ew, sw)
        np.testing.assert_array_equal(rg, rw)
        assert_same_bytes(dg, dw)


def put_both(stores, tid, x, **kw):
    for store in stores:
        store.put(x, tensor_id=tid, layout="ftsf", chunk_dims=x.ndim - 1,
                  target_file_bytes=4 << 10, **kw)


# ---------------------------------------------------------------------------
# StreamLoader parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_stream_loader_matches_ref_on_a_table_either_package_wrote(tmp_path, writer):
    tokens = [token_stream(40, 16, 1000, seed=i) for i in range(2)]
    w = ref_store(tmp_path, shards=2) if writer == "ref" else \
        port_store(tmp_path, shards=2)
    put_both([w], "ds0", tokens[0])
    put_both([w], "ds1", tokens[1])
    port, ref = port_store(tmp_path), ref_store(tmp_path)
    kw = dict(batch_size=8, seed=5, epochs=2, window=3)
    with StreamLoader(port, ["ds0", "ds1"], **kw) as a, \
            JStreamLoader(ref, ["ds0", "ds1"], **kw) as b:
        got, want = collect(a), collect(b)
        assert a.steps_per_epoch == b.steps_per_epoch == 10
    assert_same_stream(got, want)


@pytest.mark.parametrize("n_hosts,host", [(1, 0), (3, 1)])
def test_stream_loader_host_split_matches_ref(n_hosts, host):
    x = token_stream(50, 8, 500, seed=3)
    port, ref = port_store(), ref_store()
    put_both([port, ref], "ds", x)
    kw = dict(batch_size=4, seed=2, epochs=1, n_hosts=n_hosts, host_index=host)
    with StreamLoader(port, "ds", **kw) as a, JStreamLoader(ref, "ds", **kw) as b:
        np.testing.assert_array_equal(a.owned, b.owned)
        assert_same_stream(collect(a), collect(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int16", "bool"])
def test_device_cpu_yields_cpu_tensors_with_the_host_bytes(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((24, 3, 5))
    x = (x > 0) if dtype == "bool" else (x * 100).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    store = port_store(compression="zlib+shuffle")
    store.put(x, tensor_id="x", layout="ftsf", chunk_dims=2)
    kw = dict(batch_size=5, seed=1, epochs=1)
    with StreamLoader(store, "x", device=CPU, **kw) as dev_loader:
        got = collect(dev_loader)
    with StreamLoader(store, "x", **kw) as host_loader:
        want = collect(host_loader)
    for _, _, samples, data in got:
        assert isinstance(data, torch.Tensor) and data.device.type == "cpu"
        assert data.shape == (5, 3, 5)
        assert_same_bytes(as_numpy(data), x[samples])
    assert_same_stream([g[:3] + (as_numpy(g[3]),) for g in got], want)
    assert all(isinstance(w[3], np.ndarray) for w in want)
    assert store.io_stats()["bytes_to_device"] >= len(got) * 5 * 15 * x.itemsize


def test_device_true_uses_the_store_device_and_cuda_raises_without_a_card():
    store = port_store()
    store.put(rows(0, 8), tensor_id="t", layout="ftsf")
    with StreamLoader(store, "t", batch_size=4, device=True, epochs=1) as loader:
        assert loader.device == torch.device("cpu")
        b = next(iter(loader))
        assert isinstance(b["data"], torch.Tensor)
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cuda_store = DeltaTensorStore(InMemoryObjectStore(), "ts")  # device="cuda"
    cuda_store.put(rows(0, 8), tensor_id="t", layout="ftsf")
    for device in (True, "cuda"):
        with pytest.raises(RuntimeError, match="cuda"):
            StreamLoader(cuda_store, "t", batch_size=4, device=device)
    # the host path of the same store is unaffected
    with StreamLoader(cuda_store, "t", batch_size=4, epochs=1) as loader:
        assert isinstance(next(iter(loader))["data"], np.ndarray)


def test_resume_from_cursor_replays_the_ref_tail():
    x = token_stream(48, 8, 300, seed=6)
    port, ref = port_store(), ref_store()
    put_both([port, ref], "ds", x)
    kw = dict(batch_size=8, seed=9, epochs=2)
    with StreamLoader(port, "ds", start_cursor=(0, 3), **kw) as a, \
            JStreamLoader(ref, "ds", **kw) as b:
        tail, whole = collect(a), collect(b)
    assert len(tail) == len(whole) - 3
    assert_same_stream(tail, whole[3:])
    loader = StreamLoader(port, "ds", **kw)
    it = iter(loader)
    next(it), next(it)
    assert loader.cursor == (0, 2)
    loader.seek(1, 4)
    b = next(iter(loader))
    assert (b["epoch"], b["step"]) == (1, loader.steps_per_epoch + 4)
    np.testing.assert_array_equal(b["samples"], whole[loader.steps_per_epoch + 4][2])
    loader.close()
    assert loader.closed


def test_reopen_after_ingest_sees_the_new_rows_on_the_device():
    store = port_store(shards=2)
    store.put(rows(0, 8), tensor_id="t", layout="ftsf")
    loader = StreamLoader(store, "t", batch_size=4, epochs=1, seed=3, device=CPU)
    before = {b["step"]: as_numpy(b["data"]) for b in loader}
    with store.ingest("t", watermark_rows=4) as w:
        w.append_rows(rows(8, 16))
    loader.seek(0, 0)  # the pinned snapshot replays byte for byte
    again = {b["step"]: as_numpy(b["data"]) for b in loader}
    assert before.keys() == again.keys()
    for step, data in before.items():
        assert_same_bytes(again[step], data)
    reopened = loader.reopen()
    assert loader.closed and not reopened.closed
    assert reopened.device == torch.device("cpu")
    assert reopened.steps_per_epoch == 4
    seen = []
    for b in reopened:
        assert_same_bytes(as_numpy(b["data"]), rows(0, 16)[b["samples"]])
        seen.append(b["samples"])
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.arange(16))
    reopened.close()


def test_ftsf_loader_shim_matches_ref():
    tokens = token_stream(32, 12, 700, seed=8)
    port, ref = port_store(), ref_store()
    write_token_dataset(port, tokens, tensor_id="ds", target_file_bytes=1 << 10)
    from repro.data.pipeline import write_token_dataset as jwrite
    jwrite(ref, tokens, tensor_id="ds", target_file_bytes=1 << 10)
    a = FTSFLoader(port, "ds", batch_size=4, seed=7, start_step=2)
    b = JFTSFLoader(ref, "ds", batch_size=4, seed=7, start_step=2)
    assert a.step == b.step == 2
    np.testing.assert_array_equal(a.owned, b.owned)
    for _, ba, bb in zip(range(5), a, b):
        assert ba["step"] == bb["step"]
        assert_same_bytes(ba["tokens"], bb["tokens"])
        assert_same_bytes(ba["labels"], bb["labels"])
    with a, b:
        assert not a.closed
    assert a.closed and b.closed


# ---------------------------------------------------------------------------
# ingest across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_ingested_table_reads_in_the_other_package(tmp_path, writer):
    w_store = ref_store(tmp_path, compression="zlib+shuffle") if writer == "ref" \
        else port_store(tmp_path, compression="zlib+shuffle")
    w_store.put(rows(0, 5, dtype=np.float32), tensor_id="t", layout="ftsf")
    with w_store.ingest("t", watermark_rows=4, target_file_bytes=64) as w:
        for i in range(5, 19, 3):
            w.append_rows(rows(i, min(i + 3, 19), dtype=np.float32))
        assert w.flushes >= 2
    want = rows(0, 19, dtype=np.float32)
    reader = port_store(tmp_path) if writer == "ref" else ref_store(tmp_path)
    assert_same_bytes(reader.get("t"), want)
    assert_same_bytes(reader.get_slice("t", [(4, 9)]), want[4:9])
    # and the reader's own ingest continues the table the other one grew
    with reader.ingest("t", watermark_rows=2) as w:
        assert w.row_count == 19
        w.append_rows(rows(19, 21, dtype=np.float32))
    assert_same_bytes(w_store.get("t"), rows(0, 21, dtype=np.float32))


def test_ingest_writer_commits_like_the_ref():
    port, ref = port_store(), ref_store()
    out = []
    for store in (port, ref):
        w = store.ingest("t", watermark_rows=4)
        versions = [w.append_rows(rows(i, i + 1)) for i in range(10)]
        stats_open = (w.rows_pending, w.rows_committed)
        w.close()
        out.append(([v is not None for v in versions], stats_open,
                     w.stats()["flushes"], store.get("t")))
    assert out[0][:3] == out[1][:3] == (
        [False] * 3 + [True] + [False] * 3 + [True] + [False] * 2, (2, 8), 3)
    assert_same_bytes(out[0][3], out[1][3])
    with pytest.raises(ValueError, match="rows are"):
        port.ingest("t").append_rows(rows(0, 1, width=5))


@pytest.mark.parametrize("seam,rule", [
    ("before-commit", FaultRule(op="put", key="_delta_log", action="raise")),
    ("mid-seal", FaultRule(op="put", key="part-", nth=2, action="raise")),
    ("torn-upload", FaultRule(op="put", key="part-", nth=2, action="partial")),
])
def test_crash_seam_never_tears_and_vacuum_reclaims(seam, rule):
    faulty = FaultInjectingObjectStore(InMemoryObjectStore())
    store = DeltaTensorStore(faulty, "ts", device=CPU)

    def part_keys():
        return {k for k in faulty.list("")
                if k.rsplit("/", 1)[-1].startswith("part-")}

    w = store.ingest("t", watermark_rows=6, target_file_bytes=64)
    w.append_rows(rows(0, 5))
    faulty.add_rule(rule)
    with pytest.raises(InjectedFault):
        w.append_rows(rows(5, 6))  # trips the watermark
    faulty.clear_rules()
    orphans = part_keys()
    assert orphans, seam
    assert store.list_tensors() == []  # nothing torn is visible
    res = store.vacuum()
    assert set(res[0].deleted_paths) == {k.split("/", 1)[1] for k in orphans}
    assert part_keys() == set()
    w2 = store.ingest("t", watermark_rows=4)
    assert w2.row_count == 0
    w2.append_rows(rows(0, 6))
    w2.close()
    assert_same_bytes(store.get("t"), rows(0, 6))


def test_lost_commit_ack_is_not_double_ingested():
    faulty = FaultInjectingObjectStore(InMemoryObjectStore())
    store = DeltaTensorStore(faulty, "ts", device=CPU)
    w = store.ingest("t", watermark_rows=3)
    w.append_rows(rows(0, 3))
    faulty.add_rule(FaultRule(op="put", key="_delta_log", action="raise-after"))
    v = w.append_rows(rows(3, 6))
    assert v is not None and w.rows_committed == 6
    w.close()
    assert_same_bytes(store.get("t"), rows(0, 6))
    assert store.tables[0].version() == v


def test_tables_carried_across_stay_on_disk_only_as_part_files(tmp_path):
    store = port_store(tmp_path)
    with store.ingest("t", watermark_rows=2) as w:
        w.append_rows(rows(0, 4))
    names = [f for _, _, files in os.walk(tmp_path) for f in files]
    assert any(n.startswith("part-") for n in names)
    assert_same_bytes(ref_store(tmp_path).get("t"), rows(0, 4))
