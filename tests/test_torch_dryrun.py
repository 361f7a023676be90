"""The port's dry run: one rank of a cell under a fake process group.

``python -m repro_torch.launch.dryrun`` runs whisper-tiny x train_4k as
rank 0 of a (4, 4) mesh on the meta device in a subprocess (its own
process group), the cell the reference's ``tests/test_dryrun_smoke.py``
compiles: the record must say ``ok`` and count more than 1e9 FLOPs, more
than 1e8 bytes and some collective bytes. Without ``--device`` the run is
on the card, so on a host without one it fails and records the error; a
cell the skip rules rule out records ``skipped``.
"""

import json
import os
import subprocess
import sys

from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = ["--arch", "whisper-tiny", "--shape", "train_4k", "--mesh", "4x4"]


def _run(out, *extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *CELL, "--out",
         str(out), "--force", *extra], env=env, capture_output=True,
        text=True, timeout=400)


def test_dryrun_cell_runs_on_a_small_mesh(tmp_path):
    out = _run(tmp_path, "--device", "meta")
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "whisper-tiny__train_4k__4x4__meta.json")
                     .read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["corrected"]["flops"] > 1e9
    assert rec["corrected"]["bytes"] > 1e8
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["n_devices"] == 16 and rec["mesh_shape"] == [4, 4]
    assert rec["step_s"] is None and "peak_allocated_bytes" not in rec["memory"]
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["analytic"]["model_flops"] > 0


def test_dryrun_defaults_to_the_card(tmp_path):
    out = _run(tmp_path)
    assert out.returncode != 0
    rec = json.loads((tmp_path / "whisper-tiny__train_4k__4x4__cuda.json")
                     .read_text())
    assert rec["status"] == "error" and rec["device"] == "cuda"


def test_a_ruled_out_cell_is_skipped(tmp_path):
    rec = dryrun.run_cell("granite-3-8b", "long_500k", "single", str(tmp_path))
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    assert json.loads((tmp_path / "granite-3-8b__long_500k__single__cuda.json")
                      .read_text()) == rec
