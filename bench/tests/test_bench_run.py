"""``run.py`` end to end on the CPU at tiny sizes (the look for a card
skipped), its refusals, and the faults that must make ``correct`` false."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

import run
from conftest import ROOT


def _result(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]) if out else None


def test_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "granite-3-8b.bsgs_sft", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "is_available() is false" in p.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "granite-3-8b.bsgs_sft", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["tiny.bsgs", "tiny.plain"])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_runs_correct(tiny_root, capsys, cell, trace):
    seed = 2**31 + 17
    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                     "--trace", str(trace)], root=tiny_root, device="cpu") == 0
    r = _result(capsys)
    assert r["correct"] is True, r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 1 and r["failed"] == 0
    names = set(r["metrics"])
    if trace:
        assert {"loader_wait_ms", "mfu"} <= names
        assert "breakdown" in r and "busy_s" in r["device"]
    else:
        assert names == {"train_tokens_per_s", "setup_s", "step_ms_p90"}
    if cell == "tiny.bsgs":
        assert {"tiles_sent_gap", "residual_gap"} <= set(r["checks"])
        if trace:
            assert 0.05 < r["metrics"]["wire_ratio"]["value"] < 1


def test_no_forbidden_module_after_a_cell():
    """Loading the harness and running a cell leaves no top-level ``jax``,
    ``jaxlib``, ``flax`` or ``repro`` module (a fresh interpreter: this
    test process has JAX loaded by other tests)."""
    code = ("import sys; sys.path[:0] = ['bench', 'src']; import run; "
            "from yardstick import cell, program, reference, spec; "
            "from yardstick.reference import model, train; "
            "import repro_torch.train.trainer, repro_torch.data.stream; "
            "spec.load(run.ROOT, 'granite-3-8b.bsgs_sft'); "
            "print(run.forbidden_modules(), sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'repro_torch')[:1])")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith("[] ['repro_torch']")


def test_a_forbidden_module_refuses_the_result(tiny_root, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["jaxlib"]
    monkeypatch.setitem(sys.modules, "repro_torch_x", object())
    assert run.main(["--workload", "tiny.plain", "--seed", "3", "--seconds",
                     "0.2", "--trace", "0"], root=tiny_root, device="cpu") == 3
    assert _result(capsys) is None


# -- faults of the timed path: each must make `correct` false ----------------

def _frozen(make):
    import calibrate
    return calibrate.frozen_step(make)


def _half(make):
    import calibrate
    return calibrate.half_step(make)


def _alter_token(feed):
    """A token altered where the loader produces the batch."""
    inner = type(feed).__call__

    def altered(self):
        batch = inner(self)
        data = self.kept[-1][0]
        data[0, 3] = (data[0, 3] + 1) % 512
        return batch
    feed.__class__ = type("Altered", (type(feed),), {"__call__": altered})


def _no_residual(make):
    import calibrate
    return calibrate.no_residual_step(make)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.bsgs", "frozen"), ("tiny.bsgs", "half"), ("tiny.bsgs", "token"),
    ("tiny.bsgs", "no_residual"),
    ("tiny.plain", "frozen"), ("tiny.plain", "half"), ("tiny.plain", "token")])
def test_fault_makes_correct_false(tiny_root, capsys, cell, fault):
    from yardstick import program
    kw = {"frozen": {"make_step": _frozen(program.make_step)},
          "half": {"make_step": _half(program.make_step)},
          "no_residual": {"make_step": _no_residual(program.make_step)},
          "token": {"plant": _alter_token}}[fault]
    assert run.main(["--workload", cell, "--seed", "11", "--seconds", "0.3",
                     "--trace", "0"], root=tiny_root, device="cpu", **kw) == 0
    r = _result(capsys)
    assert r["correct"] is False
    failing = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    want = {"frozen": {"grad_gap", "change_gap"}, "half": {"grad_gap"},
            "no_residual": {"residual_gap"}, "token": {"batch_mismatch"}}[fault]
    assert want <= failing, r["checks"]
