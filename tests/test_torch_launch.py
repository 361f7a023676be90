"""The port's CLIs, the paper's config and the examples against the JAX
package's, on the CPU.

* ``repro_torch.launch.serve`` over a ``--weights-dir`` store that the
  reference's ``ModelRepo`` wrote, and over a ``--ckpt-dir`` that the
  reference's ``DeltaCheckpointer`` wrote (with ``--ckpt-gc-keep 1``): its
  requests' tokens equal those of ``repro.launch.serve`` on the same
  store, which draws the same prompts from the same seed (reduced configs,
  f32: greedy tokens must be identical, as ``tests/test_torch_serve.py``
  holds the engines).
* ``repro_torch.launch.ingest`` in both directions: one package's CLI
  creates the tensor, the other's resumes it from the committed row count,
  and the rows equal an ingest done wholly by the reference's CLI.
* ``repro_torch.launch.gc``: the cases ``tests/test_maintenance.py``,
  ``tests/test_cas.py`` and ``tests/test_compression.py`` run on the
  reference's CLI, run on the port's over tables the reference wrote, and
  the reference then reads them.
* ``PAPER_STORE`` equals the reference's dict.
* The examples in a subprocess with ``--device cpu``: the quickstart prints
  exactly what ``examples/quickstart.py`` prints; ``grad_compression``
  runs (its losses against the reference example's are held in
  ``tests/test_torch_grad_example.py``).
"""

import gc as _gc
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs.paper_store import PAPER_STORE as J_PAPER_STORE
from repro.core import DeltaTensorStore as JStore
from repro.core.cas import chunk_index_key
from repro.lake import LocalFSObjectStore as JLocalFS
from repro.lake import ReadExecutor as JReadExecutor
from repro.launch import ingest as jingest
from repro.launch import serve as jserve
from repro.models import get_arch as jget_arch
from repro.models import transformer as jt
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch.configs.paper_store import PAPER_STORE
from repro_torch.launch import gc as gc_cli
from repro_torch.launch import ingest
from repro_torch.launch import serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
SERVE_ARCHS = ["granite-3-8b", "granite-moe-1b-a400m", "llama-3.2-vision-11b",
               "whisper-tiny"]
SERVE_ARGS = ["--reduced", "--requests", "4", "--slots", "2", "--max-new", "6",
              "--seed", "3"]


def jax_serve(monkeypatch, argv):
    """The requests ``repro.launch.serve.main`` served for ``argv``."""
    served = []

    class Recording(jserve.ServeEngine):
        def submit(self, req):
            served.append(req)
            super().submit(req)

    monkeypatch.setattr(jserve, "ServeEngine", Recording)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    monkeypatch.undo()
    return served


def assert_same_requests(got, want):
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert np.array_equal(g.prompt, np.asarray(w.prompt)), g.rid
        assert g.done and len(g.out_tokens) > 0
        assert [int(t) for t in g.out_tokens] == \
            [int(t) for t in w.out_tokens], g.rid


# -- serve -----------------------------------------------------------------------


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_serve_over_a_weights_store_the_reference_wrote(name, tmp_path,
                                                         monkeypatch, capsys):
    jcfg = jget_arch(name).reduced()
    jstore = JStore(JLocalFS(str(tmp_path)), "weights")
    with jstore.models("serve_weights") as repo:
        repo.save(jt.init_params(jcfg, jax.random.key(11)))
    argv = ["--arch", name, "--weights-dir", str(tmp_path)] + SERVE_ARGS
    got = serve.main(argv + CPU)
    assert "loaded" in capsys.readouterr().out
    assert_same_requests(got, jax_serve(monkeypatch, argv))


def test_serve_over_a_checkpoint_the_reference_wrote(tmp_path, monkeypatch,
                                                      capsys):
    name = "granite-3-8b"
    jcfg = jget_arch(name).reduced()
    ck = jckpt.DeltaCheckpointer(JLocalFS(str(tmp_path)))
    for step, seed in ((1, 21), (2, 22)):
        ck.save(step, jtrainer.init_state(jcfg, jax.random.key(seed)))
    ck.wait()
    argv = ["--arch", name, "--ckpt-dir", str(tmp_path)] + SERVE_ARGS
    got = serve.main(argv + ["--ckpt-gc-keep", "1"] + CPU)
    out = capsys.readouterr().out
    assert "restored params from checkpoint step 2" in out
    assert "pruned steps [1]" in out
    # the port's gc left a store the reference reads: only step 2
    assert jckpt.DeltaCheckpointer(JLocalFS(str(tmp_path))).steps() == [2]
    assert_same_requests(got, jax_serve(monkeypatch, argv))


def test_serve_without_a_store_seeds_its_weights(capsys):
    a = serve.main(["--arch", "granite-3-8b"] + SERVE_ARGS + CPU)
    b = serve.main(["--arch", "granite-3-8b"] + SERVE_ARGS + CPU)
    assert [r.out_tokens for r in a] == [r.out_tokens for r in b]
    assert "4 requests" in capsys.readouterr().out


# -- ingest ------------------------------------------------------------------------


def ingest_args(d, rows):
    return ["--dir", str(d), "--root", "lake", "--tensor", "events",
            "--rows", str(rows), "--row-shape", "6,2", "--batch-rows", "7",
            "--watermark-rows", "20"]


@pytest.mark.parametrize("first", ["reference", "port"])
def test_ingest_cli_resumes_across_packages(first, tmp_path, capsys):
    # the whole ingest through the reference's CLI, twice
    want_dir = tmp_path / "want"
    assert jingest.main(ingest_args(want_dir, 50)) == 0
    assert jingest.main(ingest_args(want_dir, 30)) == 0
    want = JStore(JLocalFS(str(want_dir)), "lake").get("events")
    assert want.shape == (80, 6, 2)

    d = tmp_path / "mixed"
    port = lambda rows: ingest.main(ingest_args(d, rows) + CPU)  # noqa: E731
    ref = lambda rows: jingest.main(ingest_args(d, rows))        # noqa: E731
    one, two = (port, ref) if first == "port" else (ref, port)
    capsys.readouterr()
    assert one(50) == 0
    assert "creating 'events'" in capsys.readouterr().out
    assert two(30) == 0
    assert "resuming 'events' at committed row 50" in capsys.readouterr().out
    got = JStore(JLocalFS(str(d)), "lake").get("events")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    from repro_torch.core import DeltaTensorStore
    from repro_torch.lake import LocalFSObjectStore
    port_read = DeltaTensorStore(LocalFSObjectStore(str(d)), "lake",
                                 device="cpu").get("events")
    assert np.array_equal(port_read, want)


# -- gc ------------------------------------------------------------------------------


def jstore(d, **kw):
    return JStore(JLocalFS(str(d)), "tensors",
                  io=JReadExecutor(max_workers=2, cache_bytes=0), **kw)


def gc_args(d, *flags):
    return ["--dir", str(d), "--root", "tensors", *flags] + CPU


def test_gc_cli_compact_vacuum_roundtrip(tmp_path):
    store = jstore(tmp_path)
    x = np.arange(512, dtype=np.float32)
    store.put(x, layout="ftsf", tensor_id="a", target_file_bytes=1 << 9)
    store.put(x * 3, layout="ftsf", tensor_id="a", overwrite=True,
              target_file_bytes=1 << 9)
    files = len(store.tables[0].files())
    assert gc_cli.main(gc_args(tmp_path, "--vacuum", "--dry-run")) == 0
    assert gc_cli.main(gc_args(tmp_path, "--compact", "--vacuum",
                               "--keep-versions", "1", "--spill-index")) == 0
    fresh = jstore(tmp_path)
    np.testing.assert_array_equal(fresh.get("a"), x * 3)
    assert len(fresh.tables[0].files()) < files
    assert fresh.vacuum(dry_run=True)[0].files_deleted == 0


def dense_np(shape=(8, 64, 64), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_gc_cli_build_chunk_index(tmp_path, capsys):
    store = JStore(JLocalFS(str(tmp_path)), "tensors",
                   io=JReadExecutor(max_workers=2))
    store.put(dense_np(), tensor_id="a")
    del store
    _gc.collect()
    assert gc_cli.main(gc_args(tmp_path, "--build-chunk-index")) == 0
    assert "chunk index covers" in capsys.readouterr().out
    assert JLocalFS(str(tmp_path)).exists(chunk_index_key("tensors"))
    store = jstore(tmp_path)
    store.put(dense_np(), tensor_id="b")
    assert store.storage_stats()["dedup"]["deduped_refs"] >= 1
    assert np.array_equal(store.get("b"), dense_np())


def test_gc_cli_recompress_roundtrip(tmp_path, capsys):
    store = JStore(JLocalFS(str(tmp_path)), "tensors",
                   io=JReadExecutor(max_workers=2))
    x = (np.round(dense_np() * 64) / 64).astype(np.float32)
    store.put(x, layout="ftsf", tensor_id="t")
    raw_bytes = store.storage_stats()["physical_bytes"]
    assert gc_cli.main(gc_args(tmp_path, "--recompress", "zlib+shuffle",
                               "--vacuum", "--keep-versions", "1")) == 0
    out = capsys.readouterr().out
    assert "recompressed" in out and "storage after recompress" in out
    reopened = JStore(JLocalFS(str(tmp_path)), "tensors",
                      io=JReadExecutor(max_workers=2))
    assert np.array_equal(reopened.get("t"), x)
    stats = reopened.storage_stats()
    assert stats["physical_bytes"] < raw_bytes and stats["ratio"] > 2.0


def test_gc_cli_needs_something_to_do(tmp_path):
    with pytest.raises(SystemExit):
        gc_cli.main(gc_args(tmp_path))


# -- the paper's config and the examples ----------------------------------------------


def test_paper_store_is_the_references():
    assert PAPER_STORE == J_PAPER_STORE


def subprocess_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def run_py(args):
    r = subprocess.run([sys.executable] + args, capture_output=True,
                       text=True, env=subprocess_env(), timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_quickstart_prints_what_the_reference_prints():
    got = run_py(["-m", "repro_torch.examples.quickstart", "--device", "cpu"])
    want = run_py([os.path.join(ROOT, "examples", "quickstart.py")])
    assert got.splitlines() == want.splitlines()
    assert "time travel" in got


def test_grad_compression_example_runs_on_the_cpu():
    out = run_py(["-m", "repro_torch.examples.grad_compression", "--device",
                  "cpu", "--steps", "5"])
    assert "final: dense" in out and "cross-pod traffic cut to" in out
