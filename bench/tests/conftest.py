"""The benchmark's own tests: ``PYTHONPATH=src python -m pytest bench/tests``
from the repository root (``tests/`` is what the repository's suite
collects; these are not in it). Tests marked ``card`` need a CUDA card and
skip without one; on the chip: ``python -m pytest bench/tests -m card``."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


OPT = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
       "warmup_steps": 0, "total_steps": 10000, "min_lr_ratio": 0.1,
       "grad_clip": 1.0}
TINY_DENSE = {"name": "tiny", "family": "dense", "n_layers": 2, "d_model": 64,
              "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 128,
              "vocab_size": 512, "rope_theta": 10000.0, "norm_eps": 1e-5,
              "tie_embeddings": True, "dtype": "bfloat16"}
TINY_UNTIED = dict(TINY_DENSE, name="tinyu", tie_embeddings=False)
TINY_HYBRID = {"name": "tinyh", "family": "hybrid", "n_layers": 4,
               "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
               "d_ff": 128, "vocab_size": 512, "rope_theta": 10000.0,
               "ssm_state": 16, "ssm_head_dim": 16, "ssm_expand": 2,
               "ssm_chunk": 8, "shared_attn_every": 2, "norm_eps": 1e-5,
               "tie_embeddings": False, "dtype": "bfloat16"}
# limits for the tiny cells, from their CPU readings over six seeds
# (program / float8 control, largest / smallest: loss 5.8e-5 / 2.8e-4, grad
# 4.8e-3 / 2.2e-2, residual 1.9e-3 / 2.1e-2, change 3.0e-3 / 1.1e-3 with the
# half batch's 9.0e-3)
TINY_LIMITS = {"loss_gap": 1e-3, "grad_gap": 0.012, "residual_gap": 0.008,
               "change_gap": 0.006, "tiles_sent_gap": 0.0}


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout holding the benchmark's yardstick and metrics with a tiny
    configuration and its cells (``tiny.bsgs``, ``tiny.plain``), the
    program linked from this repository."""
    import shutil
    root = tmp_path / "checkout"
    bench = root / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "src").symlink_to(ROOT / "src")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [
        {"name": "tiny-dense", "source": "x", "file": "bench/configs/tiny-dense.json",
         "reduced": [], "why": "x"}]
    spec["workloads"] = [
        {"name": "tiny.bsgs", "config": "tiny-dense", "traffic": "tiny_bsgs", "chips": 1, "why": "x"},
        {"name": "tiny.plain", "config": "tiny-dense", "traffic": "tiny_plain", "chips": 1, "why": "x"}]
    tiny = {"granite-3-8b.bsgs_sft": "tiny.bsgs", "granite-3-8b.plain_sft": "tiny.plain"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "configs" / "tiny-dense.json").write_text(json.dumps({"arch": TINY_DENSE}))
    base = {"rows": 4, "seq_len": 32, "zipf_s": 1.1, "table_rows": 64,
            "loader_window": 4, "profile_steps": 2, "optimizer": OPT}
    mixes = {"tiny_bsgs": dict(base, step="bsgs", ratio=0.05, block=[8, 128]),
             "tiny_plain": dict(base, step="plain")}
    for name, mix in mixes.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell in ("tiny.bsgs", "tiny.plain"):
        (bench / "limits" / f"{cell}.json").write_text(json.dumps({"limits": TINY_LIMITS}))
    return root
