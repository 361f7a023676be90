"""The readers of the program's own spans (``yardstick/spans.py`` and the
metrics over it): a traced tiny cell reports them, and each reads None,
without raising, where the program has no span module or holds no
records."""

import json
import sys
from types import SimpleNamespace

import pytest

import run
from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SPANS = [m["name"] for m in SPEC["per_layer"] if m["source"] == "program_span"]
COMPRESSOR = {"compressor_ms", "topk_ms"}


@pytest.fixture
def obs():
    from repro_torch import obs
    obs.reset()
    yield obs
    obs.reset()


def test_the_span_metrics_are_the_eight():
    assert set(SPANS) == {"forward_ms", "backward_ms", "recompute_ms", "ce_ms",
                          "compressor_ms", "topk_ms", "optimizer_ms",
                          "loader_next_ms"}


@pytest.mark.parametrize("cell", ["tiny.bsgs", "tiny.plain"])
def test_a_traced_tiny_cell_reports_its_span_metrics(tiny_root, capsys, obs, cell):
    assert run.main(["--workload", cell, "--seed", str(2**31 + 5), "--seconds",
                     "0.3", "--trace", "1"], root=tiny_root, device="cpu") == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = {k: v["value"] for k, v in r["metrics"].items() if k in SPANS}
    want = set(SPANS) - (set() if cell == "tiny.bsgs" else COMPRESSOR)
    assert set(got) == want
    assert all(v > 0 for v in got.values()), got
    assert got["ce_ms"] < got["forward_ms"] + got["backward_ms"]
    assert got["recompute_ms"] < got["backward_ms"]
    if cell == "tiny.bsgs":
        assert got["topk_ms"] < got["compressor_ms"]


def _readers():
    from yardstick import spec
    return {name: spec.reader(ROOT, name) for name in SPANS}


def test_every_reader_reads_none_without_the_span_module(monkeypatch, obs):
    obs.enable()
    with obs.step():
        pass
    obs.enable(False)
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    traced = SimpleNamespace(trace=object(), mix={"profile_steps": 2})
    assert {n: r(traced) for n, r in _readers().items()} == dict.fromkeys(SPANS)


def test_every_reader_reads_none_without_records(obs):
    traced = SimpleNamespace(trace=object(), mix={"profile_steps": 2})
    untraced = SimpleNamespace(trace=None, mix={"profile_steps": 2})
    for run_ in (traced, untraced):
        assert {n: r(run_) for n, r in _readers().items()} == dict.fromkeys(SPANS)
