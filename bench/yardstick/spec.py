"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root names each cell's configuration (its ``file``) and traffic mix
(``bench/traffic/<mix>.json``); each metric's reader is
``bench/metrics/<metric>.py`` and each cell's limits
``bench/limits/<cell>.json``."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List, NamedTuple


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its files read
    (under ``root/bench``)."""
    bench = root / "bench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = bench / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text())["limits"] \
        if limits_file.exists() else {}
    return Cell(name=workload, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=[m for m in spec["end_to_end"] if _reported(m, workload)],
                per_layer=[m for m in spec["per_layer"] if _reported(m, workload)],
                limits=limits)


def reader(root: Path, name: str) -> Callable:
    """``read(run) -> float | None`` of the metric ``name``, from
    ``root/bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
