"""The port's training path (``repro_torch.train``) against the JAX package.

The same inputs (the reference's params and state carried over with
``state_from_numpy``, numpy token batches from a seed) go through both
packages on the CPU. Tolerances:

* ``loss_fn`` and its gradients (f32): loss ``rtol = 1e-6``, gradients
  ``rtol = atol = 1e-5``; XLA and torch sum in other orders. For the vlm,
  audio, ssm and hybrid families the gradients (their frontend inputs'
  included) are held to the models' ``rtol = atol = 1e-4``.
* ``schedule``: ``rtol = 1e-6``. ``optimizer.update`` on the same grads:
  f32 ``rtol = 1e-6, atol = 1e-8`` (a fused multiply-add may round once
  where XLA rounds twice); bf16 params within one bf16 ulp.
* Three train steps (f32): losses and grad norms ``rtol = 1e-5``; every
  param within ``2e-4`` (2 % of the learning rate) and 99.9 % within
  ``1e-5`` (0.1 %): Adam divides a gradient by its own root mean square,
  so a gradient element near zero, which carries XLA's and torch's
  different rounding as a large relative error, moves its param by a
  fraction of the rate either way. Moments: 99.9 % of elements within
  ``atol = 1e-6, rtol = 1e-5``.
* One train step in bf16: loss and grad norm ``rtol = 1e-2``; 99 % of the
  params within one bf16 ulp (a bf16 gradient near zero can change sign
  between the packages, and Adam's first step moves it by the full rate).
* The compressed step (f32, 2 pods, ratio 0.25): step 1 picks the same
  blocks (ids equal), its loss and grad norm ``rtol = 1e-5``, its state as
  the plain step's (residuals ``rtol = 1e-4, atol = 1e-5``); every step's
  ``wire_ratio`` equal and pods byte-identical to each other. Steps 2 and
  3: loss and grad norm ``rtol = 1e-4``, since from then on a block whose
  norm ties another's to rounding may be kept by one package and dropped
  by the other, which moves its params by a whole block's update.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DeltaTensorStore as JStore
from repro.data.pipeline import write_token_dataset as jwrite_tokens
from repro.lake import LocalFSObjectStore as JLocalFS
from repro.models import get_arch as jget_arch
from repro.models import transformer as jt
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.core import DeltaTensorStore
from repro_torch.data.pipeline import FTSFLoader
from repro_torch.data.synthetic import token_stream
from repro_torch.lake import LocalFSObjectStore
from repro_torch.models import get_arch
from repro_torch.models import transformer as tt
from repro_torch.train import grad_compress as gc
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer
from repro_torch.tree import leaves, params_from_numpy, to_numpy

CPU = "cpu"
OCFG = dict(lr=1e-2, warmup_steps=2, total_steps=50, grad_clip=1.0)
ARCHS = ["granite-3-8b", "granite-moe-1b-a400m"]


def cfgs(name, dtype="float32"):
    """(reference config, port config), reduced, in ``dtype``."""
    return (dataclasses.replace(jget_arch(name).reduced(), dtype=dtype),
            dataclasses.replace(get_arch(name).reduced(), dtype=dtype))


def batch_np(vocab, b=2, t=16, seed=0, masked=1):
    """tokens (b, t) and next-token labels, the last ``masked`` positions
    of each row -1."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, t)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    lab[:, t - masked:] = -1
    return {"tokens": tok, "labels": lab}


def to_j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_t(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def f32(x):
    return np.asarray(to_numpy(x) if isinstance(x, torch.Tensor) else x,
                      np.float32)


def ref_state_np(state):
    """The reference's state as the port's state types with numpy leaves."""
    return trainer.state_to_numpy(
        trainer.state_from_numpy(jax.tree.map(np.asarray, state), CPU))


def bf16_ulp(x):
    a = np.abs(np.asarray(x, np.float32))
    return 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-30))) - 7)


def assert_state_close(got, want):
    """Params: every element within 2e-4 and 99.9 % within 1e-5; moments:
    99.9 % within ``atol = 1e-6, rtol = 1e-5``; counts equal. Residuals
    are not compared here."""
    g, w = leaves(trainer.state_to_numpy(got)), leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        if name.startswith("residual"):
            continue
        a, b = f32(a), f32(b)
        if name in ("opt/count", "step"):
            assert a == b, name
            continue
        d = np.abs(a - b)
        if name.startswith("params/"):
            assert d.max() <= 2e-4, (name, d.max())
            assert (d > 1e-5).mean() <= 1e-3, name
        else:
            assert (d > 1e-6 + 1e-5 * np.abs(b)).mean() <= 1e-3, name


# -- loss ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("ce_chunk", [None, 5])
def test_loss_fn_and_grads_match_reference(name, ce_chunk, monkeypatch):
    """f32; ``ce_chunk=5`` over T = 16 makes four chunks, the last ragged
    (the reference pads it with masked positions)."""
    jcfg, cfg = cfgs(name)
    if ce_chunk:
        monkeypatch.setattr(jt, "CE_CHUNK", ce_chunk)
        monkeypatch.setattr(tt, "CE_CHUNK", ce_chunk)
    params = jt.init_params(jcfg, jax.random.key(1))
    b = batch_np(cfg.vocab_size, seed=1, masked=3)
    (jtotal, jm), jgrads = jax.value_and_grad(
        lambda p: jt.loss_fn(p, jcfg, to_j(b)), has_aux=True)(params)
    total, m, grads = trainer._grads(
        lambda p: tt.loss_fn(p, cfg, to_t(b)),
        params_from_numpy(jax.tree.map(np.asarray, params), CPU))
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=1e-6, atol=1e-7)
    want = leaves(jax.tree.map(np.asarray, jgrads))
    assert [n for n, _ in leaves(grads)] == [n for n, _ in want]
    for (n, g), (_, w) in zip(leaves(grads), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("name", ["llama-3.2-vision-11b", "whisper-tiny",
                                  "xlstm-1.3b", "zamba2-2.7b"])
def test_family_loss_fn_and_grads_match_reference(name):
    """f32, T = 16 (two ssm chunks); the vlm's ``image_embeds`` and the
    audio family's ``encoder_frames`` ride in the batch, and their
    gradients are compared too. Gradients are held to the models' parity
    tolerance, ``rtol = atol = 1e-4``: zamba2's embedding gradient sums
    paths through the shared attention and four Mamba2 layers to values of
    about 6, where XLA's and torch's orders of summation part by ~6e-5."""
    jcfg, cfg = cfgs(name)
    params = jt.init_params(jcfg, jax.random.key(2))
    b = batch_np(cfg.vocab_size, seed=2, masked=3)
    rng = np.random.default_rng(2)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["encoder_frames"] = rng.standard_normal(
            (2, 16 // cfg.encoder_seq_divisor, cfg.d_model)).astype(np.float32)
    extra = [k for k in b if k not in ("tokens", "labels")]
    (jtotal, jm), (jgrads, jgx) = jax.value_and_grad(
        lambda p, x: jt.loss_fn(p, jcfg, dict(to_j(b), **x)), argnums=(0, 1),
        has_aux=True)(params, {k: jnp.asarray(b[k]) for k in extra})
    tb = to_t(b)
    xs = {k: tb[k].requires_grad_() for k in extra}
    total, m, grads = trainer._grads(
        lambda p: tt.loss_fn(p, cfg, tb),
        params_from_numpy(jax.tree.map(np.asarray, params), CPU))
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    np.testing.assert_allclose(float(m["loss"].detach()), float(jm["loss"]),
                               rtol=1e-6)
    want = leaves(jax.tree.map(np.asarray, jgrads))
    assert [n for n, _ in leaves(grads)] == [n for n, _ in want]
    for (n, g), (_, w) in zip(leaves(grads), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=n)
    if extra:
        gx = torch.autograd.grad(tt.loss_fn(
            params_from_numpy(jax.tree.map(np.asarray, params), CPU), cfg,
            tb)[0], list(xs.values()))
        for k, g in zip(xs, gx):
            np.testing.assert_allclose(g.numpy(), np.asarray(jgx[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def test_chunked_ce_recomputes_each_chunk_in_the_backward_pass(monkeypatch):
    _, cfg = cfgs("granite-3-8b")
    monkeypatch.setattr(tt, "CE_CHUNK", 4)
    calls = []
    real = tt._ce_chunk
    monkeypatch.setattr(tt, "_ce_chunk",
                        lambda *a: calls.append(1) or real(*a))
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    b = to_t(batch_np(cfg.vocab_size, t=16))
    trainer._grads(lambda p: tt.loss_fn(p, cfg, b), params)
    assert len(calls) == 2 * 4   # four chunks, each run again for backward


def test_loss_is_the_mean_nll_over_unmasked_labels():
    _, cfg = cfgs("granite-3-8b")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    b = batch_np(cfg.vocab_size, t=16, masked=6)
    total, m = tt.loss_fn(params, cfg, to_t(b))
    logp = torch.log_softmax(tt.forward(params, cfg, to_t(b)["tokens"])[0], -1)
    lab = torch.as_tensor(b["labels"]).long()
    keep = lab >= 0
    want = -logp.gather(-1, lab.clamp_min(0)[..., None])[..., 0][keep].mean()
    torch.testing.assert_close(m["loss"], want, rtol=1e-6, atol=0)
    assert float(total) == float(m["loss"]) + 0.01 * float(m["aux"])
    none = {"tokens": b["tokens"], "labels": np.full_like(b["labels"], -1)}
    assert float(tt.loss_fn(params, cfg, to_t(none))[0]) == 0.0


# -- optimizer -----------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 2, 3, 50, 99, 100, 101, 5_000, 10_000,
                                  20_000])
def test_schedule_matches_reference(step):
    for ocfg in (dict(), dict(warmup_steps=0, total_steps=10, lr=1e-3)):
        want = float(jopt.schedule(jopt.OptConfig(**ocfg), jnp.asarray(step)))
        got = float(opt.schedule(opt.OptConfig(**ocfg), torch.tensor(step)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    import ml_dtypes
    params = {"w": rng.standard_normal((8, 16)).astype(np.float32),
              "b": rng.standard_normal((16,)).astype(np.float32),
              "h": {"k": rng.standard_normal((3, 4, 8)).astype(ml_dtypes.bfloat16)}}
    grads = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.3).astype(p.dtype), params)
    m = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32)
                     * 0.1, params)
    v = jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32) * 0.01,
                     params)
    return params, grads, m, v


@pytest.mark.parametrize("clip", [1.0, 100.0])   # clipping on / off
@pytest.mark.parametrize("count", [0, 3])
def test_optimizer_update_matches_reference(clip, count):
    params, grads, m, v = _opt_inputs(seed=count)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=clip)
    jstate = jopt.OptState(m=jax.tree.map(jnp.asarray, m),
                           v=jax.tree.map(jnp.asarray, v),
                           count=jnp.asarray(count, jnp.int32))
    jp, js, jm = jax.jit(lambda g, s, p: jopt.update(
        jopt.OptConfig(**ocfg), g, s, p))(
        jax.tree.map(jnp.asarray, grads), jstate,
        jax.tree.map(jnp.asarray, params))
    # the port's update below writes the numpy moments and params in place
    # (its tensors share their memory); the reference's step must have read
    # them first
    jax.block_until_ready((jp, js, jm))
    tstate = opt.OptState(m=params_from_numpy(m, CPU),
                          v=params_from_numpy(v, CPU),
                          count=torch.tensor(count, dtype=torch.int32))
    tparams = params_from_numpy(params, CPU)
    p, s, met = opt.update(opt.OptConfig(**ocfg), params_from_numpy(grads, CPU),
                           tstate, tparams)
    assert p is tparams and s.m is tstate.m     # in place
    assert int(s.count) == count + 1 and s.count.dtype == torch.int32
    np.testing.assert_allclose(float(met["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    for got, want in ((s.m, js.m), (s.v, js.v)):
        for (n, a), (_, b) in zip(leaves(got), leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-8, err_msg=n)
    for (n, a), (_, b) in zip(leaves(p), leaves(jp)):
        a_np, b_np = to_numpy(a), np.asarray(b)
        assert str(a_np.dtype) == str(b_np.dtype)
        if n == "h/k":    # bf16: one ulp
            d = np.abs(f32(a_np) - f32(b_np))
            assert (d <= bf16_ulp(b_np)).all(), n
        else:
            np.testing.assert_allclose(a_np, b_np, rtol=1e-6, atol=1e-8,
                                       err_msg=n)


def test_weight_decay_only_on_matrices():
    p = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    g = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
    opt.update(opt.OptConfig(lr=0.1, warmup_steps=0, weight_decay=0.5), g,
               opt.init(p), p)
    assert torch.all(p["b"] == 1.0)
    assert torch.all(p["w"] < 1.0)


def _per_op_leaf(cfg, g, p, m, v, scale, lr, b1c, b2c):
    """The per-op update of one plain leaf as ``optimizer.update`` ran it
    before the fused kernel, kept here as the yardstick of
    ``kernels.adamw.plain``."""
    g32 = g.to(torch.float32, copy=True).mul_(scale)
    m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
    step = torch.div(m, b1c, out=g32)
    den = torch.div(v, b2c).sqrt_().add_(cfg.eps)
    step.div_(den)
    if p.ndim >= 2:
        step.add_(p, alpha=cfg.weight_decay)
    p.copy_(step.mul_(lr).neg_().add_(p))


def _leaf_inputs(shape, p_dtype, g_dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    p = torch.randn(shape, generator=gen).to(p_dtype)
    g = (torch.randn(shape, generator=gen) * 0.3).to(g_dtype)
    m = torch.randn(shape, generator=gen) * 0.1
    v = torch.rand(shape, generator=gen) * 0.01
    return g, p, m, v


def _step_scalars(cfg, count, gnorm):
    count = torch.tensor(count, dtype=torch.int32)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(torch.tensor(gnorm),
                                                    min=1e-9), max=1.0)
    return (scale, opt.schedule(cfg, count),
            1 - torch.pow(cfg.b1, count.to(torch.float32)),
            1 - torch.pow(cfg.b2, count.to(torch.float32)))


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(-1).view(torch.uint8),
        b.contiguous().view(-1).view(torch.uint8))


@pytest.mark.parametrize("p_dtype", [torch.bfloat16, torch.float16,
                                     torch.float32])
@pytest.mark.parametrize("shape", [(6, 10), (3, 4, 8), (10,), ()],
                         ids=["matrix", "stacked", "vector", "0-d"])
@pytest.mark.parametrize("g_f32", [False, True], ids=["g_as_p", "g_f32"])
def test_adamw_plain_is_the_per_op_update_bit_for_bit(p_dtype, shape, g_f32):
    """``kernels.adamw.plain`` gives the m, v and p of the per-op update
    bit for bit: decay on (ndim >= 2) and off, every param dtype, a 0-d
    leaf, g in the param dtype or in f32 (the compressed step's mean)."""
    from repro_torch.kernels import adamw as kadamw
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    g, p, m, v = _leaf_inputs(shape, p_dtype,
                              torch.float32 if g_f32 else p_dtype, seed=7)
    scalars = _step_scalars(cfg, 1, 3.5)
    want = [t.clone() for t in (p, m, v)]
    _per_op_leaf(cfg, g, *want, *scalars)
    got = [t.clone() for t in (p, m, v)]
    kadamw.plain(g, *got, *scalars, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                 weight_decay=cfg.weight_decay)
    for name, a, b in zip("pmv", got, want):
        assert _same_bits(a, b), name
    assert not _same_bits(got[0], p)  # the step moved the params


def test_adamw_plain_reads_an_expanded_grad_as_its_copy():
    """The compressed step's mean expanded over n_pods = 2 (stride 0) gives
    the bits that the same g materialised gives."""
    from repro_torch.kernels import adamw as kadamw
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=0)
    _, p, m, v = (x[None].expand(2, 5, 8).contiguous() for x in
                  _leaf_inputs((5, 8), torch.bfloat16, torch.float32, 3))
    mean = torch.randn((5, 8), generator=torch.Generator().manual_seed(4))
    wide = mean[None].expand(2, 5, 8)
    assert wide.stride(0) == 0
    scalars = _step_scalars(cfg, 2, 0.5)
    kw = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    a = [t.clone() for t in (p, m, v)]
    b = [t.clone() for t in (p, m, v)]
    kadamw.plain(wide, *a, *scalars, **kw)
    kadamw.plain(wide.contiguous(), *b, *scalars, **kw)
    for name, x, y in zip("pmv", a, b):
        assert _same_bits(x, y), name
    assert _same_bits(a[0][0], a[0][1])  # both pods moved alike


def test_update_runs_cpu_leaves_through_plain_and_launches_nothing():
    """Leaf by leaf, ``update`` on the CPU gives what ``kernels.adamw.plain``
    gives, and counts no kernel launch."""
    from repro_torch.kernels import adamw as kadamw
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    shapes = {"w": ((6, 10), torch.bfloat16), "b": ((10,), torch.float32),
              "s": ((), torch.float32)}
    ins = {k: _leaf_inputs(sh, dt, dt, i) for i, (k, (sh, dt))
           in enumerate(shapes.items())}
    grads = {k: x[0] for k, x in ins.items()}
    params = {k: x[1].clone() for k, x in ins.items()}
    state = opt.OptState(m={k: x[2].clone() for k, x in ins.items()},
                         v={k: x[3].clone() for k, x in ins.items()},
                         count=torch.tensor(0, dtype=torch.int32))
    before = kadamw.launches
    _, new, met = opt.update(cfg, grads, state, params)
    assert kadamw.launches == before
    scalars = _step_scalars(cfg, 1, float(met["grad_norm"]))
    for k, (g, p, m, v) in ins.items():
        kadamw.plain(g, p, m, v, *scalars, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                     weight_decay=cfg.weight_decay)
        for name, a, b in (("p", params[k], p), ("m", new.m[k], m),
                           ("v", new.v[k], v)):
            assert _same_bits(a, b), (k, name)


def test_update_on_meta_leaves_runs_per_op():
    """A dry run's meta leaves have no memory for a kernel: ``update`` takes
    the per-op route there, and the shapes and dtypes come out unchanged."""
    cfg = opt.OptConfig()
    params = {"w": torch.empty((4, 8), dtype=torch.bfloat16, device="meta"),
              "b": torch.empty((8,), device="meta")}
    grads = {k: torch.empty_like(p) for k, p in params.items()}
    p, s, _ = opt.update(cfg, grads, opt.init(params), params)
    assert p["w"].is_meta and p["w"].dtype == torch.bfloat16
    assert s.m["b"].shape == (8,) and s.count.is_meta


def test_global_norm_matches_reference_on_a_broadcast_leaf():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    y = rng.standard_normal((3,)).astype(np.float32)
    want = float(jopt.global_norm({"x": jnp.broadcast_to(x, (2, 5, 7)),
                                   "y": jnp.asarray(y)}))
    got = opt.global_norm({"x": torch.as_tensor(x)[None].expand(2, 5, 7),
                           "y": torch.as_tensor(y)})
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_global_norm_is_exact_on_a_large_leaf():
    """16.8 M f32 elements: one f32 running sum over the leaf (torch's CPU
    ``vector_norm``) is 7e-4 off here; the norm must hold 1e-6."""
    x = torch.randn((4, 4096, 1024), generator=torch.Generator().manual_seed(0))
    want = float(x.double().square().sum().sqrt())
    got = float(opt.global_norm({"x": x, "s": torch.tensor(3.0)}))
    np.testing.assert_allclose(got, (want ** 2 + 9.0) ** 0.5, rtol=1e-6)


# -- the plain train step ------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference_over_three_steps(name):
    jcfg, cfg = cfgs(name)
    jstate = jtrainer.init_state(jcfg, jax.random.key(0))
    state = trainer.state_from_numpy(jax.tree.map(np.asarray, jstate), CPU)
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jopt.OptConfig(**OCFG)))
    step = trainer.make_train_step(cfg, opt.OptConfig(**OCFG))
    for i in range(3):
        b = batch_np(cfg.vocab_size, seed=10 + i)
        jstate, jm = jstep(jstate, to_j(b))
        state, m = step(state, to_t(b))
        assert set(m) == set(jm) == {"loss", "aux", "total", "lr", "grad_norm"}
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert_state_close(state, ref_state_np(jstate))
    assert int(state.step) == 3 and int(state.opt.count) == 3


def test_train_step_bf16_one_step_matches_reference():
    jcfg, cfg = cfgs("granite-3-8b", "bfloat16")
    jstate = jtrainer.init_state(jcfg, jax.random.key(0))
    state = trainer.state_from_numpy(jax.tree.map(np.asarray, jstate), CPU)
    b = batch_np(cfg.vocab_size, seed=4)
    jstate, jm = jax.jit(jtrainer.make_train_step(
        jcfg, jopt.OptConfig(**OCFG)))(jstate, to_j(b))
    state, m = trainer.make_train_step(cfg, opt.OptConfig(**OCFG))(state, to_t(b))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-2)
    total = within = 0
    for (n, a), (_, w) in zip(leaves(state.params),
                              leaves(ref_state_np(jstate).params)):
        assert a.dtype == torch.bfloat16, n
        d = np.abs(f32(a) - f32(w))
        total += d.size
        within += int((d <= bf16_ulp(w)).sum())
    assert within / total >= 0.99, within / total


def test_train_step_bf16_params_beyond_an_ulp_have_gradients_in_the_rounding():
    """Why 99 % and not all: a bf16 step-1 param more than one bf16 ulp from
    the JAX trainer's has a gradient (the reference's) no larger than the
    largest difference between the two packages' bf16 gradients of its
    leaf, so its sign is the packages' rounding, and Adam's first step
    moves it by the whole rate either way. The counts, and how many of
    those gradients have opposite signs in the two packages, are
    printed."""
    jcfg, cfg = cfgs("granite-3-8b", "bfloat16")
    jstate = jtrainer.init_state(jcfg, jax.random.key(0))
    state = trainer.state_from_numpy(jax.tree.map(np.asarray, jstate), CPU)
    b = batch_np(cfg.vocab_size, seed=4)
    jg = jax.tree.map(np.asarray, jax.grad(
        lambda p: jt.loss_fn(p, jcfg, to_j(b))[0])(jstate.params))
    _, _, g = trainer._grads(lambda p: tt.loss_fn(p, cfg, to_t(b)),
                             state.params)
    jstate, _ = jax.jit(jtrainer.make_train_step(
        jcfg, jopt.OptConfig(**OCFG)))(jstate, to_j(b))
    state, _ = trainer.make_train_step(cfg, opt.OptConfig(**OCFG))(state, to_t(b))
    beyond = flipped = total = 0
    for (n, a), (_, w), (_, gt), (_, gj) in zip(
            leaves(state.params), leaves(ref_state_np(jstate).params),
            leaves(g), leaves(jg)):
        out = np.abs(f32(a) - f32(w)) > bf16_ulp(w)
        gt, gj = f32(gt), f32(gj)
        assert (np.abs(gj[out]) <= np.abs(gt - gj).max()).all(), n
        beyond += int(out.sum())
        flipped += int((out & (np.sign(gt) != np.sign(gj))).sum())
        total += out.size
    print(f"step 1 in bf16: {beyond} of {total} params beyond one bf16 ulp "
          f"of the reference's, {flipped} of them with gradients of "
          f"opposite sign")
    assert beyond <= 0.01 * total, (beyond, total)


def test_train_step_updates_in_place_and_params_never_require_grad():
    _, cfg = cfgs("granite-3-8b")
    state = trainer.init_state(cfg, torch.Generator().manual_seed(0), device=CPU)
    before = {n: t.clone() for n, t in leaves(state.params)}
    ptrs = {n: t.data_ptr() for n, t in leaves(state)}
    new, m = trainer.make_train_step(cfg, opt.OptConfig(**OCFG))(
        state, to_t(batch_np(cfg.vocab_size)))
    assert isinstance(new, trainer.TrainState)
    assert isinstance(new.opt, opt.OptState)
    for n, t in leaves(new):
        assert not t.requires_grad, n
        if n.startswith(("params/", "opt/m/", "opt/v/")):
            assert t.data_ptr() == ptrs[n], n
    assert any(not torch.equal(before[n], t) for n, t in leaves(new.params))
    assert int(new.step) == 1 and int(state.step) == 0  # 0-d leaves are new
    assert all(not v.requires_grad for v in m.values())


def test_train_loss_decreases():
    """tests/test_train_e2e.py::test_train_loss_decreases on the port."""
    _, cfg = cfgs("granite-3-8b")
    state = trainer.init_state(cfg, torch.Generator().manual_seed(0), device=CPU)
    step = trainer.make_train_step(cfg, opt.OptConfig(**OCFG))
    b = to_t(batch_np(cfg.vocab_size, seed=0))   # overfit one batch
    losses = []
    for _ in range(12):
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses
    assert int(state.step) == 12


def test_ftsf_pipeline_feeds_trainer(tmp_path):
    """tests/test_train_e2e.py::test_ftsf_pipeline_feeds_trainer on the
    port, over a corpus the JAX package wrote."""
    _, cfg = cfgs("granite-3-8b")
    jwrite_tokens(JStore(JLocalFS(str(tmp_path)), "data"),
                  token_stream(64, 16, cfg.vocab_size), tensor_id="ds")
    loader = FTSFLoader(DeltaTensorStore(LocalFSObjectStore(str(tmp_path)),
                                         "data", device=CPU), "ds",
                        batch_size=4, seed=0)
    state = trainer.init_state(cfg, torch.Generator().manual_seed(1), device=CPU)
    step = trainer.make_train_step(cfg, opt.OptConfig(**OCFG))
    it = iter(loader)
    for _ in range(3):
        b = next(it)
        state, metrics = step(state, to_t({k: b[k] for k in ("tokens", "labels")}))
        assert np.isfinite(float(metrics["loss"]))
    loader.close()


def test_init_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, cfg = cfgs("granite-3-8b")
    # torch built without CUDA raises AssertionError, with it RuntimeError
    with pytest.raises((RuntimeError, AssertionError)):
        trainer.init_state(cfg)


# -- the compressed train step -------------------------------------------------


def _spy_ids(monkeypatch, module, records):
    """Record each leaf's ids as ``module.compressed_grad_mean`` picks them
    (under jit too, through an ordered host callback)."""
    real = module._compress_leaf

    def record(ids):
        records.append(np.asarray(ids))

    def spy(e, ratio, block=module.DEFAULT_BLOCK):
        out = real(e, ratio, block)
        if isinstance(out[0], torch.Tensor):
            record(out[0])
        else:
            jax.debug.callback(record, out[0], ordered=True)
        return out
    monkeypatch.setattr(module, "_compress_leaf", spy)


def _pod_batch(vocab, seed, pods=2):
    b = batch_np(vocab, b=2 * pods, seed=seed)
    return {k: v.reshape(pods, 2, *v.shape[1:]) for k, v in b.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_compressed_step_matches_reference_over_three_steps(name, monkeypatch):
    jcfg, cfg = cfgs(name)
    jstate = jtrainer.init_compressed_state(jcfg, jax.random.key(6), n_pods=2)
    state = trainer.state_from_numpy(jax.tree.map(np.asarray, jstate), CPU)
    assert isinstance(state, trainer.CompressedTrainState)
    jstep = jtrainer.make_compressed_train_step(jcfg, jopt.OptConfig(**OCFG),
                                                ratio=0.25)
    step = trainer.make_compressed_train_step(cfg, opt.OptConfig(**OCFG),
                                              ratio=0.25)
    for i in range(3):
        b = _pod_batch(cfg.vocab_size, seed=20 + i)
        jids, ids = [], []
        if i == 0:   # step 1's block choice, leaf by leaf, in both packages
            _spy_ids(monkeypatch, jgc, jids)
            _spy_ids(monkeypatch, gc, ids)
        # jitted after the spy went in (step 1) or came out (step 2)
        if i < 2:
            jit_step = jax.jit(jstep)
        jstate, jm = jit_step(jstate, to_j(b))
        jax.effects_barrier()
        state, m = step(state, to_t(b))
        monkeypatch.undo()
        if i == 0:
            assert len(ids) == len(jids) == len(leaves(state.params))
            for a, w in zip(ids, jids):
                np.testing.assert_array_equal(a, w)
        assert set(m) == set(jm)
        # the reference returns the ratio as f32
        assert np.float32(m["wire_ratio"]) == np.float32(jm["wire_ratio"])
        for k in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=1e-5 if i == 0 else 1e-4,
                                       err_msg=k)
        for n, p in leaves(state.params):   # pods in lockstep
            assert torch.equal(p[0], p[1]), n
        if i == 0:
            got = trainer.state_to_numpy(state)
            want = ref_state_np(jstate)
            assert_state_close(got, want)
            for (n, r), (_, w) in zip(leaves(got.residual),
                                      leaves(want.residual)):
                np.testing.assert_allclose(r, w, rtol=1e-4, atol=1e-5,
                                           err_msg=n)


def test_compressed_training_converges():
    """tests/test_train_e2e.py::test_compressed_training_converges on the
    port."""
    _, cfg = cfgs("granite-3-8b")
    state = trainer.init_compressed_state(cfg, torch.Generator().manual_seed(6),
                                          2, device=CPU)
    step = trainer.make_compressed_train_step(cfg, opt.OptConfig(**OCFG),
                                              ratio=0.25)
    b = to_t(_pod_batch(cfg.vocab_size, seed=1))
    losses = []
    for _ in range(10):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
    assert float(m["wire_ratio"]) < 0.5
    for n, p in leaves(state.params):
        assert torch.equal(p[0], p[1]), n


def test_compressed_step_error_feedback(monkeypatch):
    """The step's new residuals hold what the decode dropped: for each leaf,
    the pods' gradients minus their residuals average to the mean the
    optimizer applied (the reference's error-feedback test, at the step)."""
    _, cfg = cfgs("granite-3-8b")
    state = trainer.init_compressed_state(cfg, torch.Generator().manual_seed(2),
                                          2, device=CPU)
    seen = {}
    real = gc.compressed_grad_mean

    def spy(grads, residuals, **kw):
        seen["grads"] = {n: g.clone() for n, g in leaves(grads)}
        out = real(grads, residuals, **kw)
        seen["mean"] = dict(leaves(out[0]))
        return out
    monkeypatch.setattr(gc, "compressed_grad_mean", spy)
    new, m = trainer.make_compressed_train_step(
        cfg, opt.OptConfig(**OCFG), ratio=0.1)(
        state, to_t(_pod_batch(cfg.vocab_size, seed=3)))
    for n, r in leaves(new.residual):
        g = seen["grads"][n].float()
        torch.testing.assert_close((g - r).mean(0), seen["mean"][n],
                                   rtol=0, atol=1e-6)
    assert float(m["wire_ratio"]) < 0.2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_crosses_packages_byte_for_byte(dtype):
    jcfg, _ = cfgs("granite-moe-1b-a400m", dtype)
    for jstate in (jtrainer.init_state(jcfg, jax.random.key(0)),
                   jtrainer.init_compressed_state(jcfg, jax.random.key(0), 2)):
        ref = jax.tree.map(np.asarray, jstate)
        state = trainer.state_from_numpy(ref, CPU)
        assert type(state).__name__ == type(jstate).__name__
        back = trainer.state_to_numpy(state)
        want = jax.tree_util.tree_flatten_with_path(ref)[0]
        got = leaves(back)
        assert len(got) == len(want)
        for (n, a), (_, w) in zip(got, want):
            assert str(a.dtype) == str(w.dtype) and a.shape == w.shape, n
            assert a.tobytes() == w.tobytes(), n
        # the reference's step takes the port's state back
        b = batch_np(jcfg.vocab_size) if not hasattr(ref, "residual") \
            else _pod_batch(jcfg.vocab_size, seed=0)
        make = (jtrainer.make_compressed_train_step if hasattr(ref, "residual")
                else jtrainer.make_train_step)
        _, jm = jax.jit(make(jcfg, jopt.OptConfig(**OCFG)))(
            jax.tree.map(jnp.asarray, back), to_j(b))
        assert np.isfinite(float(jm["loss"]))
