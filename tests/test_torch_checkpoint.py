"""The port's checkpoints (``repro_torch.train.checkpoint``) and the leaf
naming they rest on (``repro_torch.tree``), against the JAX package.

Checkpoints are data movement: every restored leaf must equal the saved
one byte for byte, in the port and across the two packages in both
directions over one ``LocalFSObjectStore`` directory. The reference's
checkpoint tests (``tests/test_train_e2e.py``, ``tests/test_maintenance.py``)
run here on the port, on the CPU (``device="cpu"``).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.dist.sharding import _path_str
from repro.lake import LocalFSObjectStore as JLocalFS
from repro.models import get_arch as jget_arch
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch.core import DeltaTensorStore
from repro_torch.core.encodings.base import BF16_STAGING
from repro_torch.lake import table as table_mod
from repro_torch.lake import InMemoryObjectStore, LocalFSObjectStore
from repro_torch.launch import train as launch_train
from repro_torch.models import get_arch
from repro_torch.models.attention import KVCache
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer
from repro_torch.tree import leaves, rebuild, tree_map

from .test_torch_kernels import assert_same_bytes

CPU = "cpu"
CFG = get_arch("granite-3-8b").reduced()
JCFG = jget_arch("granite-3-8b").reduced()
BF16 = dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(),
                           dtype="bfloat16")
JBF16 = dataclasses.replace(jget_arch("granite-moe-1b-a400m").reduced(),
                            dtype="bfloat16")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def state(seed, cfg=CFG):
    return trainer.init_state(cfg, torch.Generator().manual_seed(seed),
                              device=CPU)


def template(cfg=CFG):
    return trainer.init_state(cfg, device="meta")


def assert_trees_equal(got, want):
    g, w = leaves(got), leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (n, a), (_, b) in zip(g, w):
        assert a.device.type == CPU, n
        assert_same_bytes(a, b)


# -- tree.py: NamedTuple naming and rebuild -----------------------------------


@pytest.mark.parametrize("compressed", [False, True])
def test_tree_names_namedtuple_fields_as_the_reference(compressed):
    ref = (jtrainer.init_compressed_state(JCFG, jax.random.key(0), 2)
           if compressed else jtrainer.init_state(JCFG, jax.random.key(0)))
    ref = jax.tree.map(np.asarray, ref)
    want = [_path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert [n for n, _ in leaves(ref)] == want
    assert "opt/m/embed" in want and "opt/count" in want and want[-1] == "step"
    port = trainer.state_from_numpy(ref, CPU)
    assert [n for n, _ in leaves(port)] == want
    # rebuild keeps the NamedTuple types, of either package
    again = rebuild(ref, iter([x for _, x in leaves(ref)]))
    assert type(again) is type(ref) and type(again.opt) is type(ref.opt)
    again = tree_map(lambda t: t, port)
    assert type(again) is type(port) and isinstance(again.opt, opt.OptState)


def test_tree_names_a_namedtuple_inside_a_dict():
    t = {"c": KVCache(k=torch.zeros(1), v=torch.ones(1)), "a": [torch.zeros(2)]}
    assert [n for n, _ in leaves(t)] == ["a/0", "c/k", "c/v"]
    back = tree_map(lambda x: x + 1, t)
    assert isinstance(back["c"], KVCache) and isinstance(back["a"], list)
    assert float(back["c"].v) == 2.0


# -- the reference's checkpoint tests, on the port ----------------------------


def test_checkpoint_save_restore_roundtrip():
    s = state(2)
    ck = ckpt_mod.DeltaCheckpointer(InMemoryObjectStore(), device=CPU)
    ck.save(0, s)
    step_found, restored = ck.restore(template())
    assert step_found == 0
    assert isinstance(restored, trainer.TrainState)
    assert_trees_equal(restored, s)


def test_checkpoint_incremental_skips_unchanged():
    s = state(3)
    store = InMemoryObjectStore()
    ck = ckpt_mod.DeltaCheckpointer(store, device=CPU)
    ck.save(0, s)
    n_files_0 = len(list(store.list("checkpoints/")))
    ck.save(1, s)  # nothing changed -> only a manifest row
    n_files_1 = len(list(store.list("checkpoints/")))
    assert n_files_1 - n_files_0 <= 4  # manifest + log + checkpoint artifacts
    _, restored = ck.restore(template(), step=1)
    assert_trees_equal(restored, s)


def test_checkpoint_async_and_crash_recovery():
    s = state(4)
    store = InMemoryObjectStore()
    ck = ckpt_mod.DeltaCheckpointer(store, device=CPU)
    ck.save_async(0, s)
    ck.wait()
    assert ck.steps() == [0]
    # crash mid-upload of the next checkpoint: inject failure
    store.fail_after_puts = store._puts + 2
    s2 = tree_map(lambda x: x if x.dtype == torch.int32 else x + 1, s)
    with pytest.raises(IOError):
        ck.save(1, s2)
    store.fail_after_puts = None
    # the failed checkpoint is invisible; restore returns step 0 intact
    step_found, restored = ckpt_mod.DeltaCheckpointer(store, device=CPU) \
        .restore(template())
    assert step_found == 0
    assert_trees_equal(restored, s)
    # and the failed save did not poison the incremental skip: a retry
    # uploads every changed leaf
    ck.save(1, s2)
    assert_trees_equal(ck.restore(template(), step=1)[1], s2)


def test_checkpoint_elastic_shard_restore():
    """Restore only one host's shard via slice reads (resharded restart)."""
    s = state(5)
    ck = ckpt_mod.DeltaCheckpointer(InMemoryObjectStore(), device=CPU)
    ck.save(0, s)
    emb = s.params["embed"]
    half = emb.shape[0] // 2
    _, restored = ck.restore(
        {"params": {"embed": torch.empty((half, emb.shape[1]),
                                         dtype=emb.dtype, device="meta")}},
        shard_slices={"params/embed": [(0, half)]})
    assert_same_bytes(restored["params"]["embed"], emb[:half])


def test_save_async_snapshots_before_returning():
    s = state(6)
    ck = ckpt_mod.DeltaCheckpointer(InMemoryObjectStore(), device=CPU)
    want = tree_map(torch.clone, s)
    ck.save_async(0, s)
    for _, t in leaves(s):          # the next step updates in place
        t.add_(1)
    ck.wait()
    assert_trees_equal(ck.restore(template())[1], want)


def test_zero_dim_leaves_restore_with_shape_and_dtype():
    s = state(7)._replace(step=torch.tensor(41, dtype=torch.int32))
    s = s._replace(opt=s.opt._replace(count=torch.tensor(41, dtype=torch.int32)))
    ck = ckpt_mod.DeltaCheckpointer(InMemoryObjectStore(), device=CPU)
    ck.save(41, s)
    _, r = ck.restore(template())
    for t in (r.step, r.opt.count):
        assert t.shape == () and t.dtype == torch.int32 and int(t) == 41
    assert r.params["final_norm"]["scale"].shape == (CFG.d_model,)
    _, only = ck.restore({"step": torch.empty((), dtype=torch.int32,
                                              device="meta")})
    assert int(only["step"]) == 41


def test_leaf_hash_names_bf16_without_ml_dtypes():
    x = np.arange(12, dtype=np.float32).reshape(3, 4).astype(ml_dtypes.bfloat16)
    staged = x.view(np.uint16).view(BF16_STAGING)
    assert ckpt_mod._leaf_hash(staged) == ckpt_mod._leaf_hash(x)
    assert ckpt_mod._leaf_hash(x.view(np.uint16)) != ckpt_mod._leaf_hash(x)


def test_checkpoint_roundtrip_on_sharded_store():
    s = {f"layer{i}": torch.full((4, 3), float(i)) for i in range(8)}
    obj = InMemoryObjectStore()
    ck = ckpt_mod.DeltaCheckpointer(obj, "ckpts", shards=3, device=CPU)
    ck.save(3, s)
    assert len({ck.store.shard_of(f"layer{i}@3") for i in range(8)}) > 1
    step, restored = ckpt_mod.DeltaCheckpointer(obj, "ckpts", device=CPU) \
        .restore(tree_map(lambda t: t.to("meta"), s))
    assert step == 3
    assert_trees_equal(restored, s)


def test_restore_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    obj = InMemoryObjectStore()
    ckpt_mod.DeltaCheckpointer(obj, device=CPU).save(0, {"w": torch.ones(3)})
    from repro_torch.lake import set_unshuffle_kernel
    try:
        ck = ckpt_mod.DeltaCheckpointer(obj)          # device="cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            ck.restore({"w": torch.empty(3, device="meta")})
        # a host restore onto the CPU still works from the same object
        _, r = ck.restore({"w": torch.empty(3, device="meta")}, device=CPU)
        assert torch.equal(r["w"], torch.ones(3))
    finally:
        set_unshuffle_kernel(None)


def test_bf16_checkpoint_without_ml_dtypes(tmp_path):
    """The card's machine has numpy without ml_dtypes: bf16 leaves stage as
    ``BF16_STAGING``, restore as torch.bfloat16 byte for byte, and hash as
    bfloat16, so an unchanged state saves no tensor again."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None  # import ml_dtypes raises ImportError
        import dataclasses, torch
        from repro_torch.lake import LocalFSObjectStore
        from repro_torch.models import get_arch
        from repro_torch.train import checkpoint, trainer
        from repro_torch.tree import leaves
        cfg = dataclasses.replace(get_arch("granite-3-8b").reduced(),
                                  dtype="bfloat16")
        s = trainer.init_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        obj = LocalFSObjectStore({str(tmp_path)!r})
        ck = checkpoint.DeltaCheckpointer(obj, device="cpu")
        ck.save_async(1, s)
        ck.wait()
        n = len(list(obj.list("checkpoints/")))
        ck.save(2, s)
        print("new files", len(list(obj.list("checkpoints/"))) - n)
        _, r = ck.restore(trainer.init_state(cfg, device="meta"))
        for (name, a), (_, b) in zip(leaves(r), leaves(s)):
            assert a.dtype == b.dtype and torch.equal(
                a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                b.view(torch.int16) if b.dtype == torch.bfloat16 else b), name
        print("ok", r.params["embed"].dtype)
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "ok torch.bfloat16"
    assert int(lines[-2].split()[-1]) <= 4   # a manifest row, no tensor
    # the JAX package (with ml_dtypes) reads it as bfloat16 too
    jck = jckpt.DeltaCheckpointer(JLocalFS(str(tmp_path)))
    cfg16 = dataclasses.replace(JCFG, dtype="bfloat16")
    _, got = jck.restore(jtrainer.init_state(cfg16, jax.random.key(0)))
    assert str(np.asarray(got.params["embed"]).dtype) == "bfloat16"


@pytest.mark.parametrize("compression", [None, "zlib+shuffle"])
def test_parallel_part_encode_writes_the_serial_bytes(compression, monkeypatch):
    """A tensor's part files encode on several threads and upload in row
    order: the stored files are those of a serial writer, byte for byte,
    and identical chunks of one tensor still do not alias each other."""
    x = np.random.default_rng(0).standard_normal((64, 1000)).astype(np.float32)
    x[32:] = 0.0
    out = []
    for cpus in (1, 8):
        monkeypatch.setattr(table_mod.os, "cpu_count", lambda: cpus)
        obj = InMemoryObjectStore()
        store = DeltaTensorStore(obj, "t", compression=compression, device=CPU)
        store.put(x, tensor_id="x", layout="ftsf", chunk_dims=1,
                  target_file_bytes=16_000)
        adds = store.table.plan_scan(partition_filters={"tensor": "x"})
        assert not any("physPath" in a for a in adds)
        out.append(sorted(
            (repr(a["stats"]), obj.get(f"t/{table_mod.physical_path(a)}"))
            for a in adds))
        assert_same_bytes(store.get("x"), x)
    assert len(out[0]) > 8 and out[0] == out[1]


@pytest.mark.parametrize("cpus", [1, 2, 3])
def test_part_encodes_ahead_of_the_upload_are_bounded(cpus, monkeypatch):
    """At most ``AHEAD_PER_WORKER`` encoded parts per thread are held
    between their encode and their upload, however slow the uploads; the
    add-actions (in row order, paths aside) and the stored bytes are a
    serial writer's."""
    import threading
    import time
    x = np.random.default_rng(1).standard_normal((48, 500)).astype(np.float32)
    live, peak, lock = [0], [0], threading.Lock()
    real_encode, real_place = table_mod._encode_part, table_mod.DeltaTable._place
    real_split = table_mod.DeltaTable.append_split

    def encode(*args, **kw):
        part = real_encode(*args, **kw)
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        return part

    def place(self, part, **kw):
        time.sleep(0.002)          # an upload slower than an encode
        add = real_place(self, part, **kw)
        with lock:
            live[0] -= 1
        return add

    def split(self, *args, **kw):
        adds = real_split(self, *args, **kw)
        runs[-1].append(adds)
        return adds

    monkeypatch.setattr(table_mod.DeltaTable, "append_split", split)
    runs = []
    for n_cpus, spy in ((1, False), (cpus, True)):
        monkeypatch.setattr(table_mod.os, "cpu_count", lambda: n_cpus)
        if spy:
            monkeypatch.setattr(table_mod, "_encode_part", encode)
            monkeypatch.setattr(table_mod.DeltaTable, "_place", place)
        runs.append([])
        obj = InMemoryObjectStore()
        store = DeltaTensorStore(obj, "t", compression="zlib+shuffle",
                                 device=CPU)
        store.put(x, tensor_id="x", layout="ftsf", chunk_dims=1,
                  target_file_bytes=2000)
        runs[-1] = [[(dict((k, v) for k, v in a.items() if k != "path"),
                      obj.get(f"t/{table_mod.physical_path(a)}"))
                     for a in adds] for adds in runs[-1]]
        assert_same_bytes(store.get("x"), x)
    assert runs[0] == runs[1]
    assert sum(len(adds) for adds in runs[1]) == 49   # 48 rows + a header
    assert live[0] == 0
    assert 1 <= peak[0] <= table_mod.AHEAD_PER_WORKER * cpus


# -- retention (tests/test_maintenance.py on the port) ------------------------


def _data_keys(obj, root):
    return [k for k in obj.list(f"{root}/")
            if "_delta_log" not in k and "/_catalog/" not in k]


def _ckpt_state(step):
    return {"hot": torch.full((24, 24), float(step)),
            "frozen": torch.arange(64, dtype=torch.float32)}


def test_checkpointer_keeps_last_k_and_gc_reclaims():
    obj = InMemoryObjectStore()
    ck = ckpt_mod.DeltaCheckpointer(obj, "ck", keep_checkpoints=2, device=CPU)
    for step in (1, 2, 3, 4):
        ck.save(step, _ckpt_state(step))
    assert ck.store.leases.active == 2     # sliding lease window
    bytes_before = sum(obj.head(k) for k in _data_keys(obj, "ck"))
    res = ck.gc()
    assert res["pruned_steps"] == [1, 2]
    assert res["bytes_reclaimed"] > 0
    assert ck.steps() == [3, 4]
    assert sum(obj.head(k) for k in _data_keys(obj, "ck")) < bytes_before
    # the incrementally reused frozen leaf (chunks written at step 1) stays
    step, s = ck.restore(_ckpt_state(0))
    assert step == 4
    assert_trees_equal(s, _ckpt_state(4) | {"frozen": _ckpt_state(0)["frozen"]})
    with pytest.raises(KeyError):
        ck.restore(_ckpt_state(0), step=1)


def test_checkpointer_lease_blocks_external_prune_and_vacuum():
    obj = InMemoryObjectStore()
    ck = ckpt_mod.DeltaCheckpointer(obj, "ck", keep_checkpoints=2, device=CPU)
    for step in (1, 2, 3):
        ck.save(step, _ckpt_state(step))
    other = ckpt_mod.DeltaCheckpointer(obj, "ck", device=CPU)
    assert other.prune(keep=1) == [1, 2]
    other.store.vacuum(keep_versions=1)
    step, s = ck.restore(_ckpt_state(0), step=2)   # pinned restore
    assert step == 2
    assert torch.equal(s["hot"], _ckpt_state(2)["hot"])
    assert ck.restore(_ckpt_state(0))[0] == 3


def test_gc_dry_run_commits_and_deletes_nothing():
    obj = InMemoryObjectStore()
    ck = ckpt_mod.DeltaCheckpointer(obj, "ck", keep_checkpoints=1, device=CPU)
    for step in (1, 2, 3):
        ck.save(step, _ckpt_state(step))
    keys = set(obj.list("ck/"))
    version = ck.store.version()
    res = ck.gc(dry_run=True)
    assert res["pruned_steps"] == [] and res["files_compacted"] == 0
    assert set(obj.list("ck/")) == keys
    assert ck.store.version() == version


def test_prune_needs_keep():
    ck = ckpt_mod.DeltaCheckpointer(InMemoryObjectStore(), device=CPU)
    with pytest.raises(ValueError):
        ck.prune()
    assert ck.prune(keep=1) == []
    assert not ck.restore_available()


# -- checkpoints across the packages ------------------------------------------


@pytest.mark.parametrize("jcfg,cfg", [(JCFG, CFG), (JBF16, BF16)],
                         ids=["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, jcfg, cfg):
    ref = jtrainer.init_state(jcfg, jax.random.key(8))
    jck = jckpt.DeltaCheckpointer(JLocalFS(str(tmp_path)))
    jck.save(5, ref)
    jck.save(6, ref._replace(step=ref.step + 6))   # incremental: only step
    ck = ckpt_mod.DeltaCheckpointer(LocalFSObjectStore(str(tmp_path)),
                                    device=CPU)
    assert ck.steps() == [5, 6]
    step, got = ck.restore(template(cfg), step=5)
    assert step == 5 and isinstance(got, trainer.TrainState)
    assert_trees_equal(got, trainer.state_from_numpy(
        jax.tree.map(np.asarray, ref), CPU))
    step, got = ck.restore(template(cfg))
    assert step == 6 and int(got.step) == 6


@pytest.mark.parametrize("jcfg,cfg", [(JCFG, CFG), (JBF16, BF16)],
                         ids=["float32", "bfloat16"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, jcfg, cfg):
    s = state(9, cfg)
    ck = ckpt_mod.DeltaCheckpointer(LocalFSObjectStore(str(tmp_path)),
                                    device=CPU)
    ck.save(3, s)
    jck = jckpt.DeltaCheckpointer(JLocalFS(str(tmp_path)))
    step, got = jck.restore(jtrainer.init_state(jcfg, jax.random.key(0)))
    assert step == 3
    want = leaves(trainer.state_to_numpy(s))
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [_path_str(p) for p, _ in flat] == [n for n, _ in want]
    for (_, a), (n, w) in zip(flat, want):
        a = np.asarray(a)
        assert str(a.dtype) == str(w.dtype) and a.shape == w.shape, n
        assert a.tobytes() == w.tobytes(), n


# -- the launcher and the example ---------------------------------------------


def test_launch_train_resumes_from_the_last_commit(tmp_path, capsys):
    argv = ["--reduced", "--steps", "4", "--ckpt-every", "2", "--batch", "2",
            "--seq", "16", "--device", CPU,
            "--ckpt-dir", str(tmp_path / "ck"), "--data-dir", str(tmp_path / "d")]
    launch_train.main(argv)
    assert "checkpoints at steps [2, 4]" in capsys.readouterr().out
    argv[2] = "6"
    launch_train.main(argv)
    out = capsys.readouterr().out
    assert "resumed from committed step 4" in out
    assert "checkpoints at steps [2, 4, 6]" in out
    ck = ckpt_mod.DeltaCheckpointer(LocalFSObjectStore(str(tmp_path / "ck")),
                                    device=CPU)
    assert int(ck.restore(template())[1].step) == 6


def test_train_lm_example_runs_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_lm", "--device", CPU,
         "--steps", "20", "--batch", "4", "--ckpt-every", "5"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "restored checkpoint of step 10" in r.stdout
    assert "checkpoints at steps [5, 10, 15, 20]" in r.stdout
