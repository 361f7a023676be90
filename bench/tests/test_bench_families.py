"""The model families as modules found by name (``yardstick/families/``):
the moved code reproduces what the yardstick read before the move, number
for number (``golden_families.json``), a family is added as one new file,
and an unknown family names the file that was looked for."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, TINY_DENSE, TINY_HYBRID, TINY_UNTIED
from test_bench_arithmetic import CONFIGS

GOLDEN = json.loads((BENCH / "tests" / "golden_families.json").read_text())["configs"]
ARCHS = dict(CONFIGS, **{a["name"]: a for a in (TINY_DENSE, TINY_UNTIED, TINY_HYBRID)})
TINY = [a["name"] for a in (TINY_DENSE, TINY_UNTIED, TINY_HYBRID)]
SIZES = ((8, 256), (1, 4096))


def _digest(w):
    h = hashlib.sha256()
    for name, t in w.items():
        h.update(name.encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _reference(arch):
    """The f32 reference's loss and gradient norms on the batch of
    ``test_bench_reference.py``."""
    from yardstick import traffic, weights
    from yardstick.reference import model
    arch = dict(arch, dtype="float32")
    w = {k: v.requires_grad_() for k, v in weights.draw(arch, 5, "cpu").items()}
    table = torch.from_numpy(traffic.token_table(
        5, {"table_rows": 2, "seq_len": 32, "zipf_s": 1.1}, 512))
    batch = traffic.split_batch(table, 32)
    value = model.loss(w, arch, batch["tokens"], batch["labels"])
    grads = torch.autograd.grad(value, list(w.values()))
    return float(value.detach()), {k: float(g.norm()) for k, g in zip(w, grads)}


def test_golden_covers_every_config():
    assert sorted(GOLDEN) == sorted(ARCHS)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_layout_and_arithmetic_as_before(name):
    from yardstick import accounting, weights
    arch, want = ARCHS[name], GOLDEN[name]
    got = [[leaf.name, list(leaf.shape), str(leaf.dtype).replace("torch.", ""),
            leaf.init, leaf.std] for leaf in weights.layout(arch)]
    assert got == want["layout"]
    assert accounting.param_count(arch) == want["param_count"]
    assert accounting.applied_params(arch) == want["applied_params"]
    for b, t in SIZES:
        key = f"{b}x{t}"
        assert accounting.attention_flops(arch, b, t).hex() == want["attention_flops"][key]
        assert accounting.train_step_flops(arch, b, t).hex() == want["train_step_flops"][key]


@pytest.mark.parametrize("name", TINY)
def test_weights_and_reference_as_before(name):
    from yardstick import weights
    arch, want = ARCHS[name], GOLDEN[name]
    assert _digest(weights.draw(arch, 5, "cpu")) == want["weights_seed5"]
    loss, norms = _reference(arch)
    assert loss.hex() == want["f32_loss"]
    assert {k: v.hex() for k, v in norms.items()} == want["f32_grad_norms"]


def test_unknown_family_names_the_file():
    from yardstick import accounting, families, weights
    from yardstick.reference import model
    arch = dict(TINY_DENSE, family="moe_mixed")
    path = str(families.DIR / "moe_mixed.py")
    for call in (lambda: weights.layout(arch), lambda: accounting.param_count(arch),
                 lambda: accounting.applied_params(arch),
                 lambda: accounting.attention_flops(arch, 1, 8),
                 lambda: model.loss({}, arch, None, None)):
        with pytest.raises(ValueError, match="looked for") as e:
            call()
        assert path in str(e.value)


def test_a_family_is_one_new_file(tmp_path):
    """A renamed copy of ``dense.py`` in a copy of the benchmark is found by
    its name, with no other file changed, and reads as ``dense`` does."""
    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(bench / "yardstick" / "families" / "dense.py",
                bench / "yardstick" / "families" / "dense_copy.py")
    code = f"""
import json, sys, torch
sys.path[:0] = [{str(bench)!r}]
from yardstick import accounting, families, weights
from yardstick.reference import model
dense = json.loads({json.dumps(json.dumps(TINY_DENSE))})
dense["dtype"] = "float32"
copy = dict(dense, family="dense_copy")
assert families.load(copy).__file__.startswith({str(bench)!r})
assert weights.layout(copy) == weights.layout(dense)
w = weights.draw(copy, 3, "cpu")
tok = torch.randint(0, 512, (2, 9), generator=torch.Generator().manual_seed(3))
assert torch.equal(model.loss(w, copy, tok[:, :-1], tok[:, 1:]),
                   model.loss(w, dense, tok[:, :-1], tok[:, 1:]))
for f in ("param_count", "applied_params"):
    assert getattr(accounting, f)(copy) == getattr(accounting, f)(dense)
assert accounting.train_step_flops(copy, 2, 8) == accounting.train_step_flops(dense, 2, 8)
print("ok")
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr
