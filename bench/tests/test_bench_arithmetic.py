"""The frozen arithmetic against the program's own and against counts by
hand: parameters and FLOPs, the weights' layout, the BSGS payload, the
kernels' bytes."""

import json
import math

import pytest
import torch

from conftest import BENCH, TINY_DENSE, TINY_HYBRID, TINY_UNTIED

# the hybrid family's arithmetic at zamba2-2.7b's widths and depth (no cell
# runs it yet)
ZAMBA2 = {"name": "zamba2-2.7b", "family": "hybrid", "n_layers": 54,
          "d_model": 2560, "n_heads": 32, "n_kv_heads": 32, "head_dim": 80,
          "d_ff": 10240, "vocab_size": 32000, "rope_theta": 10000.0,
          "ssm_state": 64, "ssm_head_dim": 64, "ssm_expand": 2, "ssm_chunk": 128,
          "shared_attn_every": 6, "norm_eps": 1e-05, "tie_embeddings": False,
          "dtype": "bfloat16"}
CONFIGS = {"granite-3-8b": json.loads(
    (BENCH / "configs" / "granite-3-8b.json").read_text())["arch"],
    "zamba2-2.7b": ZAMBA2}
PARAMS = {"granite-3-8b": 2_193_719_296, "zamba2-2.7b": 2_422_386_848}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_count_equals_the_program(name):
    from repro_torch.analysis import accounting as prog
    from yardstick import accounting, program, weights
    arch = CONFIGS[name]
    cfg = program.arch_config(arch)
    assert accounting.param_count(arch) == PARAMS[name]
    assert prog.param_counts(cfg)["total"] == PARAMS[name]
    assert weights.numel(arch) == PARAMS[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_flops_against_the_program(name):
    """Equal to the port's ``model_flops + attn_flops`` for the dense
    family; the hybrid family also counts the shared block at each of its
    applications, which the port's 6 N D counts once."""
    from repro_torch.analysis import accounting as prog
    from yardstick import accounting, program
    arch = CONFIGS[name]
    b, t = (8, 256) if arch["family"] == "dense" else (1, 4096)
    theirs = prog.model_flops(program.arch_config(arch), "train", b, t)
    ours = accounting.train_step_flops(arch, b, t)
    extra = 0.0
    if arch["family"] == "hybrid":
        shared = accounting.attn_mlp_params(arch)
        extra = 6.0 * shared * (arch["n_layers"] // arch["shared_attn_every"] - 1) * b * t
    assert ours == pytest.approx(theirs["model_flops"] + theirs["attn_flops"] + extra,
                                 rel=1e-12)


@pytest.mark.parametrize("arch", list(CONFIGS.values())
                         + [TINY_DENSE, TINY_UNTIED, TINY_HYBRID],
                         ids=lambda a: a["name"])
def test_layout_is_the_programs_tree(arch):
    from yardstick import program, weights
    program.check_layout(program.arch_config(arch), weights.layout(arch))


def test_weights_repeat_from_the_seed():
    from yardstick import weights
    a = weights.draw(TINY_HYBRID, 2**31 + 5, "cpu")
    b = weights.draw(TINY_HYBRID, 2**31 + 5, "cpu")
    c = weights.draw(TINY_HYBRID, 2**31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert float(a["embed"].float().std()) == pytest.approx(0.02, rel=0.05)


def test_wire_ratio_equals_the_programs_stats():
    from repro_torch.train import grad_compress
    from yardstick import wire
    shapes = [(2, 37, 300), (5,), (1, 130), (16, 256)]
    grads = {str(i): torch.randn((1,) + s) for i, s in enumerate(shapes)}
    resid = {k: torch.zeros_like(v) for k, v in grads.items()}
    _, _, stats = grad_compress.compressed_grad_mean(grads, resid, ratio=0.05)
    sent, dense = wire.wire_bytes(shapes, 0.05, (8, 128))
    assert (sent, dense) == (stats["sent_bytes"], stats["dense_bytes"])
    assert wire.wire_ratio(shapes, 0.05, (8, 128)) == \
        grad_compress.compression_ratio_bytes(stats)


def test_wire_ratio_reader_equals_the_programs_stats():
    """The metric, from the tile gathers the probes note, equals the
    program's own count of the payload in one compressed step."""
    from types import SimpleNamespace
    from repro_torch.train import grad_compress
    from yardstick import program, spec
    from conftest import ROOT
    shapes = [(2, 37, 300), (5,), (1, 130), (16, 256)]
    grads = {str(i): torch.randn((1,) + s) for i, s in enumerate(shapes)}
    resid = {k: torch.zeros_like(v) for k, v in grads.items()}
    probes = program.Probes()
    with probes.active():
        _, _, stats = grad_compress.compressed_grad_mean(grads, resid, ratio=0.05)
    assert len(probes.gathers) == len(shapes)
    got = spec.reader(ROOT, "wire_ratio")(SimpleNamespace(probes=probes))
    assert got == grad_compress.compression_ratio_bytes(stats)
    assert spec.reader(ROOT, "wire_ratio")(
        SimpleNamespace(probes=program.Probes())) is None


def test_wire_ratio_of_the_cells():
    """0.05 x (1 + 4 / (8 x 128)) on the large leaves, more on the small."""
    from yardstick import weights, wire
    for arch in CONFIGS.values():
        r = wire.wire_ratio([leaf.shape for leaf in weights.layout(arch)], 0.05, (8, 128))
        assert 0.05 < r < 0.0506


def test_kernel_bytes_by_hand():
    from yardstick import kernel_bytes as kb
    # a (10, 300) f32 operand in (8, 128) tiles: a 2 x 3 grid, ragged on
    # both edges; tile 5 (row 1, col 2) holds 2 x 44 elements
    assert kb.tile_elements(10, 300, 8, 128, [0]) == 8 * 128
    assert kb.tile_elements(10, 300, 8, 128, [5]) == 2 * 44
    assert kb.block_norms(10, 300, 8, 128, 4) == 10 * 300 * 4 + 6 * 4
    assert kb.block_gather(10, 300, 8, 128, 4, [0, 5]) == \
        2 * 4 + (8 * 128 + 2 * 44) * 4 + 2 * 8 * 128 * 4
    assert kb.block_scatter(10, 300, 8, 128, 4, [0, 5], True) == \
        2 * 4 + 2 * 8 * 128 * 4 + (8 * 128 + 2 * 44) * 4
    assert kb.block_scatter(10, 300, 8, 128, 4, [5], False) == \
        4 + 8 * 128 * 4 + 88 * 4 + 2 * 10 * 300 * 4
    assert math.isclose(kb.block_norms(8, 128, 8, 128, 2), 8 * 128 * 2 + 4)
