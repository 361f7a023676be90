"""The port's serving path (``repro_torch.serve``) against the JAX package.

``ModelRepo`` tables cross between the packages in both directions, every
leaf byte-identical (bf16 included), on a ``zlib+shuffle`` local-filesystem
store that both packages open, with the port's frame-decode hook on its
plain CPU version. The port's ``ServeEngine`` is held to the JAX engine
token for token on the same weights (the scenarios of
``tests/test_serve.py``), and to its own offline prefill + decode loop.
Everything runs on the CPU (``device="cpu"``).
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.lake as jlake
from repro.models import get_arch as jget_arch
from repro.models import transformer as jt
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.core import DeltaTensorStore
from repro_torch.kernels import ops
from repro_torch.lake import (InMemoryObjectStore, LocalFSObjectStore,
                              ReadExecutor, set_unshuffle_kernel)
from repro_torch.models import get_arch
from repro_torch.models import transformer as tt
from repro_torch.serve import (ModelRepo, Request, ServeEngine, load_weights,
                               save_weights)
from repro_torch.tree import leaves, params_from_numpy, tree_map

from .test_torch_kernels import assert_same_bytes

CPU = "cpu"
JCFG = jget_arch("granite-3-8b").reduced()
CFG = get_arch("granite-3-8b").reduced()
COMPRESSION = "zlib+shuffle"


@pytest.fixture(autouse=True)
def _cpu_unshuffle_hook():
    """The port's frame-decode hook on its plain version, for each test."""
    set_unshuffle_kernel(functools.partial(ops.unshuffle_host, device=CPU))
    yield
    set_unshuffle_kernel(None)


def jparams(cfg, seed):
    """The reference's params as host numpy (bf16 as ml_dtypes)."""
    return jax.tree.map(np.asarray, jt.init_params(cfg, jax.random.key(seed)))


def port_store(root, **kw):
    return DeltaTensorStore(LocalFSObjectStore(str(root)), "weights",
                            compression=COMPRESSION, device=CPU, **kw)


def ref_store(root):
    return jcore.DeltaTensorStore(jlake.LocalFSObjectStore(str(root)),
                                  "weights", compression=COMPRESSION)


def assert_same_tree(got, want):
    got_l, want_l = leaves(got), leaves(want)
    assert [n for n, _ in got_l] == [n for n, _ in want_l]
    for (_, g), (_, w) in zip(got_l, want_l):
        assert_same_bytes(g, w)


# ---------------------------------------------------------------------------
# ModelRepo across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_saves_port_loads(tmp_path, dtype):
    cfg = dataclasses.replace(JCFG, dtype=dtype)
    params = jparams(cfg, 0)
    with ref_store(tmp_path).models("granite") as repo:
        repo.save(params)
    store = port_store(tmp_path)
    template = tt.init_params(dataclasses.replace(CFG, dtype=dtype),
                              device="meta")
    with store.models("granite") as repo:
        assert sorted(repo.leaf_ids()) == sorted(
            f"granite/{n}" for n, _ in leaves(params))
        store.io.stats.reset()
        got = repo.load(template)   # the store's device: the CPU here
    assert all(t.device.type == "cpu" for _, t in leaves(got))
    assert got["embed"].dtype == getattr(torch, dtype)
    assert store.io_stats()["bytes_to_device"] == sum(
        a.nbytes for _, a in leaves(params))
    assert_same_tree(got, params)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_saves_reference_loads(tmp_path, dtype):
    cfg = dataclasses.replace(CFG, dtype=dtype)
    gen = torch.Generator().manual_seed(1)
    params = tt.init_params(cfg, gen, device=CPU)
    with port_store(tmp_path).models("granite") as repo:
        tids = repo.save(params)
    assert len(tids) == len(leaves(params))
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    template = jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.key(0)))
    with ref_store(tmp_path).models("granite") as repo:
        got = repo.load(template)
    assert got["embed"].dtype == np.dtype(jnp.dtype(dtype))
    assert_same_tree(got, params)


def test_port_writes_bfloat16_headers_without_ml_dtypes(tmp_path):
    """On a host without ml_dtypes the port stages bf16 as uint16, yet its
    headers must say bfloat16, so the reference reads bf16 back."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None  # import ml_dtypes raises ImportError
        import torch
        from repro_torch.core import DeltaTensorStore
        from repro_torch.lake import LocalFSObjectStore
        x = (torch.arange(24, dtype=torch.float32) / 7).reshape(2, 3, 4)
        store = DeltaTensorStore(LocalFSObjectStore({str(tmp_path)!r}),
                                 "weights", device="cpu")
        with store.models("m") as repo:
            repo.save({{"w": x.to(torch.bfloat16), "f": x}})
            back = repo.load({{"w": x.to(torch.bfloat16), "f": x}})
        assert back["w"].dtype == torch.bfloat16
        assert torch.equal(back["w"], x.to(torch.bfloat16))
        assert "ml_dtypes" not in [m for m in sys.modules
                                   if sys.modules[m] is not None]
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    store = jcore.DeltaTensorStore(jlake.LocalFSObjectStore(str(tmp_path)),
                                   "weights")
    want = (np.arange(24, dtype=np.float32) / 7).reshape(2, 3, 4)
    with store.models("m") as repo:
        got = repo.load({"w": jax.ShapeDtypeStruct((2, 3, 4), jnp.bfloat16),
                         "f": want})
    assert str(got["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(got["w"], want.astype(jnp.bfloat16))
    np.testing.assert_array_equal(got["f"], want)


def test_variant_delta_round_trip_across_packages(tmp_path):
    base = params_from_numpy(jparams(JCFG, 2), CPU)
    ft = dict(base, embed=base["embed"] * 2.0)
    store = port_store(tmp_path)
    with store.models("base") as repo:
        repo.save(base)
        with repo.open_variant("ft") as var:
            assert var.prefix == "base~ft" and var.base is repo
            var.save(ft)
            assert var.stats()["is_variant"]
            assert_same_tree(var.load(base), ft)
    with store.models("base~ft") as again:   # a fresh handle, no base repo
        assert_same_tree(again.load(base), ft)
    # the reference reads the port's delta variant back too
    with ref_store(tmp_path).models("base~ft") as ref:
        assert_same_tree(ref.load(jax.tree.map(np.asarray, jparams(JCFG, 2))),
                         ft)


def test_resave_replaces_previous_generation():
    store = DeltaTensorStore(InMemoryObjectStore(), "weights", device=CPU)
    params = params_from_numpy(jparams(JCFG, 3), CPU)
    with store.models("w") as repo:
        repo.save(params)
        n_files = len(store.table.files())
        bumped = tree_map(lambda v: v + 1, params)
        repo.save(bumped)
        assert len(store.table.files()) == n_files  # old files removed
        assert_same_tree(repo.load(params), bumped)


def test_pinning_and_refresh():
    store = DeltaTensorStore(InMemoryObjectStore(), "weights", device=CPU)
    params = {"layer0": torch.arange(12.0).reshape(3, 4),
              "layer1": torch.ones(5)}
    with store.models("m") as repo:
        assert not repo.exists()
        repo.save(params)
        assert repo.exists()
        assert repo.leaf_ids() == ["m/layer0", "m/layer1"]
        v1 = repo.version
        with store.models("m") as w:
            w.save({k: v + 1 for k, v in params.items()})
        assert repo.version == v1   # another handle's save moves no pin
        assert_same_tree(repo.load(params), params)
        assert_same_tree(repo.load(params, version=v1), params)
        repo.refresh()
        assert repo.version != v1
        assert torch.equal(repo.load(params)["layer0"], params["layer0"] + 1)
        assert repo.stats()["leaves"] == 2
    assert repo.closed


def test_empty_store_load_raises():
    store = DeltaTensorStore(InMemoryObjectStore(), "weights", device=CPU)
    with store.models("nothing") as repo:
        with pytest.raises(KeyError):
            repo.load({"w": torch.zeros(2)})
    with pytest.raises(ValueError):
        ModelRepo(store, "")


def test_load_casts_to_template_dtype_and_shims_warn():
    store = DeltaTensorStore(InMemoryObjectStore(), "weights",
                             io=ReadExecutor(max_workers=2), device=CPU)
    params = {"a": torch.arange(6, dtype=torch.float32)}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tids = save_weights(store, params, prefix="w")
        got = load_weights(store, {"a": torch.zeros(6, dtype=torch.float64)},
                           prefix="w")
    assert any(issubclass(w.category, DeprecationWarning) for w in rec)
    assert tids == ["w/a"]
    assert got["a"].dtype == torch.float64
    assert torch.equal(got["a"], params["a"].double())


# ---------------------------------------------------------------------------
# ServeEngine against the reference engine
# ---------------------------------------------------------------------------

def _requests(cls, cfg):
    rng = np.random.default_rng(0)
    return [cls(rid=i,
                prompt=rng.integers(0, cfg.vocab_size, (4 + 3 * i,)).astype(np.int32),
                max_new_tokens=5 + i)
            for i in range(5)]  # 5 requests through 2 slots, ragged lengths


def test_engine_continuous_batching_matches_reference():
    jp = jt.init_params(JCFG, jax.random.key(0))
    jeng = JServeEngine(jp, JCFG, n_slots=2, max_len=64)
    jreqs = _requests(JRequest, JCFG)
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained(max_iters=200)

    params = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    eng = ServeEngine(params, CFG, n_slots=2, max_len=64)
    reqs = _requests(Request, CFG)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_iters=200)
    for r, jr in zip(reqs, jreqs):
        assert r.done
        assert len(r.out_tokens) == r.max_new_tokens
        assert r.out_tokens == jr.out_tokens


def test_engine_matches_offline_decode():
    """Engine output == plain prefill + decode_step for a single request,
    in the port and in the reference."""
    jp = jt.init_params(JCFG, jax.random.key(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    prompt = np.arange(6, dtype=np.int32) % CFG.vocab_size

    caches = tt.init_caches(CFG, 1, 32, device=CPU)
    logits, caches, _ = tt.prefill(params, CFG,
                                   torch.from_numpy(prompt[None]).long(), caches)
    ref = [int(logits[0, -1].argmax())]
    for _ in range(4):
        lg, caches, _ = tt.decode_step(params, CFG,
                                       torch.tensor([[ref[-1]]]), caches)
        ref.append(int(lg[0, 0].argmax()))

    jcaches = jt.init_caches(JCFG, 1, 32)
    lj, jcaches, _ = jt.prefill(jp, JCFG, jnp.asarray(prompt[None]), jcaches)
    jref = [int(jnp.argmax(lj[0, -1]))]
    for _ in range(4):
        lj, jcaches, _ = jt.decode_step(
            jp, JCFG, jnp.asarray([[jref[-1]]], jnp.int32), jcaches)
        jref.append(int(jnp.argmax(lj[0, 0])))
    assert ref == jref

    eng = ServeEngine(params, CFG, n_slots=1, max_len=32)
    req = Request(rid=0, prompt=prompt, max_new_tokens=5)
    eng.submit(req)
    eng.run_until_drained(max_iters=50)
    assert req.out_tokens == ref


def test_engine_from_repo_owns_the_lease(tmp_path):
    store = port_store(tmp_path)
    params = params_from_numpy(jparams(JCFG, 4), CPU)
    with store.models("m") as writer:
        writer.save(params)
    repo = store.models("m")
    template = tt.init_params(CFG, device="meta")
    with ServeEngine.from_repo(repo, template, CFG, n_slots=1,
                               max_len=16) as eng:
        assert not eng.closed and not repo.closed
        assert_same_tree(eng.params, params)
        req = Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                      max_new_tokens=3)
        eng.submit(req)
        eng.run_until_drained(max_iters=50)
        assert req.done and len(req.out_tokens) == 3
    assert eng.closed and repo.closed
    with pytest.raises(RuntimeError):
        eng.submit(Request(rid=1, prompt=np.zeros(2, np.int32)))


def test_serve_example_runs_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_lm", "--device",
         "cpu", "--requests", "3", "--slots", "2", "--max-new", "3",
         "--layers", "2", "--from-store"],
        capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "served 3 requests, 9 tokens" in r.stdout
    assert "weights loaded from delta store" in r.stdout
