"""BENCHMARK.json and the files it names: every cell, configuration, mix
and metric reader is found by name, and every name and unit keeps to the
contract's characters."""

import json
import re

import pytest

from conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1] == "bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_found_by_name(cell):
    from yardstick import spec
    c = spec.load(ROOT, cell["name"])
    assert c.chips == 1
    assert c.config["arch"]["name"] == cell["config"]
    assert c.mix["step"] in ("bsgs", "plain")
    assert {"setup_s", "train_tokens_per_s"} <= {m["name"] for m in c.end_to_end}
    assert c.per_layer
    assert c.limits, "a cell without limits is never correct"
    if c.mix["step"] == "bsgs":
        assert {"loss_gap", "grad_gap", "change_gap", "tiles_sent_gap",
                "residual_gap"} <= set(c.limits)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    from yardstick import spec
    assert callable(spec.reader(ROOT, metric["name"]))
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in SPEC["per_layer"]:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_names_files_and_reductions():
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names)
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(conf["reduced"])
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
