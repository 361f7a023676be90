"""The port's dry run: one rank of a cell under a fake process group.

``python -m repro_torch.launch.dryrun`` runs whisper-tiny x train_4k as
rank 0 of a (4, 4) mesh on the meta device in a subprocess (its own
process group), the cell the reference's ``tests/test_dryrun_smoke.py``
compiles: the record must say ``ok`` and count more than 1e9 FLOPs, more
than 1e8 bytes and some collective bytes. Without ``--device`` the run is
on the card, so on a host without one it fails and records the error; a
cell the skip rules rule out records ``skipped``. Two serving cells run
on the same small mesh on meta: decode from a cache split over it, each
record with its collectives by the op that caused them. ``--layers 2``
cuts granite-3-8b's train cell to 2 layers. ``--lock``'s exclusive file lock keeps a
second holder waiting until the first lets go; its shared lock lets a
second shared holder in.
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = ["--arch", "whisper-tiny", "--shape", "train_4k", "--mesh", "4x4"]


def _run(out, *extra, cell=CELL):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *cell, "--out",
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


@pytest.mark.parametrize("arch,shape", [("granite-3-8b", "decode_32k"),
                                        ("h2o-danube-3-4b", "long_500k")])
def test_a_decode_cell_runs_on_a_small_mesh(tmp_path, arch, shape):
    """A serving cell as rank 0 of (4, 4) on meta: granite's 8 kv heads
    split 4 ways (the cache splits heads), h2o's ring cache of its window.
    The record holds what a train cell's does, and the collectives by the
    op that caused them; none moves as much as one layer's k shard."""
    out = _run(tmp_path, "--device", "meta",
               cell=["--arch", arch, "--shape", shape, "--mesh", "4x4"])
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / f"{arch}__{shape}__4x4__meta.json")
                     .read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["corrected"]["flops"] > 1e8
    assert rec["corrected"]["bytes"] > 1e8
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["analytic"]["model_flops"] > 0
    coll = rec["collectives"]
    assert coll["total_bytes"] > 0
    assert sum(v["bytes"] for ops in coll["by_op"].values()
               for v in ops.values()) == coll["total_bytes"]
    assert {k: sum(v["count"] for v in ops.values())
            for k, ops in coll["by_op"].items()} == coll["count_by_kind"]
    big = coll["largest"]
    assert big["op"] in coll["by_op"][big["kind"]]
    assert big["bytes"] >= max(v["bytes"] / v["count"] for ops in
                               coll["by_op"].values() for v in ops.values())
    # one layer's k shard on the rank: rows / 4, positions (a window-sized
    # ring for h2o), kv heads / 4, head_dim, bf16
    rows, positions, heads, hd = ((128 // 4, 32768, 8 // 4, 128)
                                  if shape == "decode_32k" else
                                  (1, 4096, 8 // 4, 120))
    assert big["bytes"] < rows * positions * heads * hd * 2, big


def test_a_cell_cut_to_two_layers_counts_less(tmp_path):
    """``--layers 2`` runs granite-3-8b x train_4k on meta as
    ``granite-3-8b@2`` (published widths): its record counts the cut
    depth's work, 6 N D of the 2-layer model over the 16 ranks within
    twice (attention and recompute come on top), well under a twentieth
    of the 40 layers'."""
    out = _run(tmp_path, "--device", "meta", "--layers", "2",
               cell=["--arch", "granite-3-8b", "--shape", "train_4k",
                     "--mesh", "4x4"])
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "granite-3-8b@2__train_4k__4x4__meta.json")
                     .read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["arch"] == "granite-3-8b@2"
    flops, model = rec["corrected"]["flops"], rec["analytic"]["model_flops"]
    assert 1.0 <= flops * 16 / model <= 2.0, (flops, model)
    # embedding and unembedding aside, 2 of 40 layers
    assert model < 0.2 * 6 * 8.2e9 * 256 * 4096, model


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


def test_a_cell_holding_the_lock_keeps_another_waiting(tmp_path):
    """``--lock``: while one dry run holds the file's lock exclusively
    (its timed step), another can take it in no way; while it holds it
    shared (its build and counted step), another can take it shared, not
    exclusively; once the first lets go, it can."""
    import fcntl
    path = tmp_path / "card.lock"
    with dryrun._holding(str(path)):
        for mode in (fcntl.LOCK_SH, fcntl.LOCK_EX):
            with open(path) as other:
                with pytest.raises(BlockingIOError):
                    fcntl.flock(other, mode | fcntl.LOCK_NB)
    with dryrun._holding(str(path), shared=True):
        with open(path) as other:
            fcntl.flock(other, fcntl.LOCK_SH | fcntl.LOCK_NB)
            fcntl.flock(other, fcntl.LOCK_UN)
        with open(path) as other:
            with pytest.raises(BlockingIOError):
                fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
    with open(path) as other:
        fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
