"""The plain reference against the program in f32 at tiny sizes: the
same loss and gradients from the same weights and tokens (so the
reference computes what the configuration states, and a gap on the card
is precision or a fault), its compressor against the program's, and the
float8 control's distance from it."""

import pytest
import torch

from conftest import OPT, TINY_DENSE, TINY_HYBRID, TINY_UNTIED


def _f32(arch):
    return dict(arch, dtype="float32")


@pytest.mark.parametrize("arch", [TINY_DENSE, TINY_UNTIED, TINY_HYBRID],
                         ids=lambda a: a["name"])
def test_loss_and_grads_equal_the_programs_in_f32(arch):
    from repro_torch.models import transformer
    from repro_torch.tree import leaves
    from yardstick import program, traffic, weights
    from yardstick.reference import model
    arch = _f32(arch)
    cfg = program.arch_config(arch)
    w = weights.draw(arch, 5, "cpu")
    table = torch.from_numpy(traffic.token_table(5, {"table_rows": 2, "seq_len": 32,
                                                      "zipf_s": 1.1}, 512))
    batch = traffic.split_batch(table, 32)
    params = {k: v.clone().requires_grad_() for k, v in w.items()}
    total, _ = transformer.loss_fn(program.nest(params), cfg, batch)
    g_prog = torch.autograd.grad(total, list(params.values()))
    ref = {k: v.clone().requires_grad_() for k, v in w.items()}
    value = model.loss(ref, arch, batch["tokens"], batch["labels"])
    g_ref = torch.autograd.grad(value, list(ref.values()))
    assert float(value.detach()) == pytest.approx(float(total.detach()), rel=1e-5)
    for name, a, b in zip(params, g_prog, g_ref):
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-5 * float(b.abs().max())), name
    assert [n for n, _ in leaves(program.nest(params))] == list(params)


def test_compressor_equals_the_programs():
    from repro_torch.train import grad_compress
    from yardstick.reference import train
    torch.manual_seed(0)
    shapes = [(3, 40, 300), (7,), (2, 130)]
    e = {str(i): torch.randn((1,) + s) for i, s in enumerate(shapes)}
    mean, new_r, _ = grad_compress.compressed_grad_mean(
        e, {k: torch.zeros_like(v) for k, v in e.items()}, ratio=0.05)
    for k, x in e.items():
        sent = train.compress(x[0], 0.05, (8, 128))
        assert torch.equal(sent, mean[k])
        assert torch.equal(x[0] - sent, new_r[k][0])


def test_compress_works_in_row_chunks(monkeypatch):
    from yardstick.reference import train
    x = torch.randn(40, 8, 300)
    whole = train.compress(x, 0.05, (8, 128))
    monkeypatch.setattr(train, "ROWS", 16)
    assert torch.equal(train.compress(x, 0.05, (8, 128)), whole)
    assert train.nonzero_tiles(whole, (8, 128)) == int(40 * 8 / 8 * 3 * 0.05)


def test_adamw_step_equals_the_programs():
    from repro_torch.train import optimizer as opt
    from yardstick.reference import model, train
    arch = _f32(TINY_DENSE)
    from yardstick import weights
    w0 = weights.draw(arch, 9, "cpu")
    tok = torch.randint(0, 512, (2, 33))
    mix = {"step": "plain", "optimizer": OPT}
    out = train.run(arch, mix, {k: v.clone() for k, v in w0.items()},
                    [(tok[:, :-1], tok[:, 1:])] * 3)
    # the program's optimizer on the reference's own gradients, step 1
    params = {k: v.clone().requires_grad_() for k, v in w0.items()}
    g = torch.autograd.grad(model.loss(params, arch, tok[:, :-1], tok[:, 1:]),
                            list(params.values()))
    p = {k: v.detach().clone() for k, v in params.items()}
    new, state, om = opt.update(opt.OptConfig(**OPT), dict(zip(p, g)), opt.init(p), p)
    for k in p:
        assert float(state.m[k].norm()) / 0.1 == pytest.approx(out["grad_norms"][k],
                                                               rel=1e-5)


def test_control_is_far_from_the_reference():
    """The float8 control's loss and gradient norms are far from the f32
    reference's, where bf16 rounding of the same weights is near."""
    from yardstick import weights
    from yardstick.reference import model
    arch = dict(_f32(TINY_DENSE), d_model=128, head_dim=32, d_ff=256)
    w = weights.draw(arch, 1, "cpu")
    tok = torch.randint(0, 512, (4, 33), generator=torch.Generator().manual_seed(1))
    exact = model.loss(w, arch, tok[:, :-1], tok[:, 1:])
    fp8 = model.loss(w, arch, tok[:, :-1], tok[:, 1:], mm=model.fp8_matmul)

    def bf16(x, y):
        return (x.to(torch.bfloat16) @ y.to(torch.bfloat16)).float()
    half = model.loss(w, arch, tok[:, :-1], tok[:, 1:], mm=bf16)
    assert abs(float(fp8 - exact)) > 3 * abs(float(half - exact))
