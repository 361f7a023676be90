"""The port's state-space blocks (``repro_torch.models.ssm``) against the
JAX package's ``repro.models.ssm``.

The same numpy inputs (from a seed) and the same params (the reference's
initialisers, carried over with ``params_from_numpy``) go through both
packages on the CPU, for the reduced zamba2 (Mamba2) and xlstm (mLSTM,
sLSTM) configs. f32 results are held to ``rtol = atol = 1e-4`` (XLA and
torch sum in other orders), bf16 ones to ``rtol = atol = 2e-2`` (one or two
bf16 rounding steps on values of order 1). Each block runs its chunked /
per-token branch (no cache, and a prefill that fills a cache) and its
decode branch (T == 1 with a cache); its new cache is compared leaf by
leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_arch as jget_arch
from repro.models import ssm as jssm
from repro_torch.models import get_arch, ssm
from repro_torch.tree import leaves, params_from_numpy, to_numpy

RTOL = ATOL = 1e-4
BF16_TOL = 2e-2
CPU = "cpu"


def cfgs(name, dtype="float32"):
    """(reference config, port config), reduced, in ``dtype``."""
    return (dataclasses.replace(jget_arch(name).reduced(), dtype=dtype),
            dataclasses.replace(get_arch(name).reduced(), dtype=dtype))


def close(got, want, tol=RTOL):
    np.testing.assert_allclose(np.asarray(to_numpy(got), np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def core_inputs(b=2, t=16, h=3, n=4, p=5, seed=0, lo=0.5):
    """q, k (B,T,H,N), v (B,T,H,P) normal; a (B,T,H) in [lo, 1)."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, t, h, n)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, t, h, p)).astype(np.float32)
    a = rng.uniform(lo, 1.0, (b, t, h)).astype(np.float32)
    return q, k, v, a


def j(*xs):
    return [jnp.asarray(x) for x in xs]


def t_(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# -- the chunked core -----------------------------------------------------------


@pytest.mark.parametrize("t,chunk", [(16, 8), (24, 8), (5, 8), (8, 8)])
@pytest.mark.parametrize("with_init", [False, True])
def test_gla_chunked_matches(t, chunk, with_init):
    q, k, v, a = core_inputs(t=t, seed=t)
    s0 = np.random.default_rng(1).standard_normal((2, 3, 4, 5)).astype(np.float32)
    yj, sj = jssm.gla_chunked(*j(q, k, v, a), chunk,
                              init_state=jssm.GLAState(jnp.asarray(s0))
                              if with_init else None)
    yt, st = ssm.gla_chunked(*t_(q, k, v, a), chunk,
                             init_state=ssm.GLAState(torch.from_numpy(s0))
                             if with_init else None)
    close(yt, yj)
    close(st.s, sj.s)


def test_gla_chunked_rejects_a_ragged_length_as_the_reference():
    q, k, v, a = core_inputs(t=12)
    with pytest.raises(AssertionError):
        jssm.gla_chunked(*j(q, k, v, a), 8)
    with pytest.raises(AssertionError):
        ssm.gla_chunked(*t_(q, k, v, a), 8)


def test_gla_step_matches_and_chains_to_the_chunked_core():
    q, k, v, a = core_inputs(t=6, seed=3)
    sj = jssm.GLAState(jnp.zeros((2, 3, 4, 5), jnp.float32))
    st = ssm.GLAState(torch.zeros((2, 3, 4, 5)))
    ys = []
    for i in range(6):
        sl = slice(i, i + 1)
        yj, sj = jssm.gla_step(*j(q[:, sl], k[:, sl], v[:, sl], a[:, sl]), sj)
        yt, st = ssm.gla_step(*t_(q[:, sl], k[:, sl], v[:, sl], a[:, sl]), st)
        close(yt, yj)
        close(st.s, sj.s)
        ys.append(yt)
    # six recurrent steps are the chunked core over the six tokens
    yc, sc = ssm.gla_chunked(*t_(q, k, v, a), 8)
    close(torch.cat(ys, 1), yc.numpy())
    close(st.s, sc.s.numpy())


def test_gla_chunked_gradients_match():
    q, k, v, a = core_inputs(t=16, seed=4)
    want = jax.grad(lambda *xs: jnp.sum(jssm.gla_chunked(*xs, 8)[0] ** 2),
                    argnums=(0, 1, 2, 3))(*j(q, k, v, a))
    xs = [x.requires_grad_() for x in t_(q, k, v, a)]
    (ssm.gla_chunked(*xs, 8)[0] ** 2).sum().backward()
    for x, w in zip(xs, want):
        close(x.grad, w)


def test_gla_chunked_gradients_stay_finite_under_strong_decay():
    """Decay strong enough that exp(cum_i - cum_j) above the diagonal
    overflows: the forward values equal the reference's, and the port's
    gradients stay finite where the reference's gradient of ``a`` is NaN
    (the port masks the exponent, the reference the overflowed result)."""
    q, k, v, a = core_inputs(t=16, seed=5)
    a[:] = 1e-30
    a[:, ::3] = 0.5
    yj, _ = jssm.gla_chunked(*j(q, k, v, a), 8)
    xs = [x.requires_grad_() for x in t_(q, k, v, a)]
    yt, _ = ssm.gla_chunked(*xs, 8)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=RTOL, atol=RTOL * np.abs(yj).max())
    yt.sum().backward()
    assert all(bool(torch.isfinite(x.grad).all()) for x in xs)
    ga = jax.grad(lambda a: jnp.sum(jssm.gla_chunked(*j(q, k, v), a, 8)[0]))(
        jnp.asarray(a))
    assert np.isnan(np.asarray(ga)).any()


# -- the causal conv ----------------------------------------------------------------


def test_conv_apply_and_steps_match():
    rng = np.random.default_rng(6)
    p = jssm.conv_init(jax.random.key(6), 10, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, p), CPU)
    x = rng.standard_normal((2, 7, 10)).astype(np.float32)
    want = jssm.conv_apply(p, jnp.asarray(x))
    close(ssm.conv_apply(tp, torch.from_numpy(x)), want)
    sj = jnp.zeros((2, ssm.CONV_K - 1, 10), jnp.float32)
    st = torch.zeros((2, ssm.CONV_K - 1, 10))
    for i in range(7):
        yj, sj = jssm.conv_step(p, jnp.asarray(x[:, i:i + 1]), sj)
        yt, st = ssm.conv_step(tp, torch.from_numpy(x[:, i:i + 1]), st)
        close(yt, yj)
        close(st, sj)
        close(yt, np.asarray(want)[:, i:i + 1])   # steps == the whole conv


# -- the blocks -------------------------------------------------------------------

BLOCKS = {  # name: (config, init, apply, cache init)
    "mamba2": ("zamba2-2.7b", "mamba2_init", "mamba2_apply",
               lambda m, cfg, b: m.mamba2_cache_init(cfg, b, jnp.float32)
               if m is jssm else m.mamba2_cache_init(cfg, b, torch.float32, CPU)),
    "mlstm": ("xlstm-1.3b", "mlstm_init", "mlstm_apply",
              lambda m, cfg, b: m.mlstm_cache_init(cfg, b) if m is jssm
              else m.mlstm_cache_init(cfg, b, CPU)),
    "slstm": ("xlstm-1.3b", "slstm_init", "slstm_apply",
              lambda m, cfg, b: m.slstm_cache_init(cfg, b) if m is jssm
              else m.slstm_cache_init(cfg, b, CPU)),
}


def block_setup(block, dtype="float32", seed=0):
    name, init, apply, cache_init = BLOCKS[block]
    jcfg, cfg = cfgs(name, dtype)
    jdtype = jnp.dtype(dtype)
    p = getattr(jssm, init)(jax.random.key(seed), jcfg, jdtype)
    # non-trivial f32 leaves (the reference draws a_log, dt_bias, d_skip as
    # constants): seeded values of the same shapes
    rng = np.random.default_rng(seed)
    for leaf in ("a_log", "dt_bias", "d_skip"):
        if leaf in p:
            p[leaf] = jnp.asarray(rng.uniform(-0.5, 1.0, p[leaf].shape)
                                  .astype(np.float32))
    tp = params_from_numpy(jax.tree.map(np.asarray, p), CPU)
    return (jcfg, cfg, p, tp, getattr(jssm, apply), getattr(ssm, apply),
            cache_init)


def x_of(cfg, b, t, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


def close_cache(got, want, tol=RTOL):
    g, w = leaves(got), leaves(jax.tree.map(np.asarray, want))
    assert [n for n, _ in g] == [n for n, _ in w]
    for (_, a), (_, b) in zip(g, w):
        assert str(to_numpy(a).dtype) == str(b.dtype)
        close(a, b, tol)


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("t", [16, 8, 5])
def test_block_without_cache_matches(block, t):
    jcfg, cfg, p, tp, japply, tapply, _ = block_setup(block, seed=t)
    xj, xt = x_of(cfg, 2, t, seed=t)
    yj, cj = japply(p, xj, jcfg)
    yt, ct = tapply(tp, xt, cfg)
    assert cj is None and ct is None
    close(yt, yj)


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_prefill_then_decode_matches(block):
    """Prefill fills a zero cache (the chunked / per-token branch), then
    three decode steps (the T == 1 branch) carry it on; a one-token call
    with a cache takes the decode branch."""
    jcfg, cfg, p, tp, japply, tapply, cache_init = block_setup(block, seed=7)
    xj, xt = x_of(cfg, 2, 16, seed=7)
    yj, cj = japply(p, xj, jcfg, cache=cache_init(jssm, jcfg, 2))
    yt, ct = tapply(tp, xt, cfg, cache=cache_init(ssm, cfg, 2))
    close(yt, yj)
    close_cache(ct, cj)
    for s in range(3):
        xj, xt = x_of(cfg, 2, 1, seed=20 + s)
        yj, cj = japply(p, xj, jcfg, cache=cj)
        yt, ct = tapply(tp, xt, cfg, cache=ct)
        close(yt, yj)
        close_cache(ct, cj)


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_decode_equals_the_whole_sequence(block):
    """Prefill of 8 tokens then 8 decode steps equals one prefill of the
    16 tokens (the port alone: its two branches agree)."""
    _, cfg, _, tp, _, tapply, cache_init = block_setup(block, seed=8)
    _, xt = x_of(cfg, 2, 16, seed=8)
    whole, c_whole = tapply(tp, xt, cfg, cache=cache_init(ssm, cfg, 2))
    y, c = tapply(tp, xt[:, :8], cfg, cache=cache_init(ssm, cfg, 2))
    ys = [y]
    for s in range(8, 16):
        y, c = tapply(tp, xt[:, s:s + 1], cfg, cache=c)
        ys.append(y)
    close(torch.cat(ys, 1), whole.numpy())
    for (_, a), (_, b) in zip(leaves(c), leaves(c_whole)):
        close(a, b.numpy())


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_in_bf16(block):
    """bf16 params and activations: the reference's casts (``v_in`` in the
    value dtype, ``v_aug`` built in it, the core's output and sLSTM's hidden
    states cast back before the norm) are the port's."""
    jcfg, cfg, p, tp, japply, tapply, cache_init = block_setup(
        block, "bfloat16", seed=9)
    xj, xt = x_of(cfg, 2, 8, seed=9, dtype="bfloat16")
    yj, cj = japply(p, xj, jcfg, cache=cache_init(jssm, jcfg, 2))
    yt, ct = tapply(tp, xt, cfg, cache=cache_init(ssm, cfg, 2))
    assert yt.dtype == torch.bfloat16
    close(yt, yj, BF16_TOL)
    close_cache(ct, cj, BF16_TOL)
    xj, xt = x_of(cfg, 2, 1, seed=10, dtype="bfloat16")
    yj, cj = japply(p, xj, jcfg, cache=cj)
    yt, ct = tapply(tp, xt, cfg, cache=ct)
    close(yt, yj, BF16_TOL)
    close_cache(ct, cj, BF16_TOL)


def test_dims_and_param_shapes_match_at_full_size():
    """Published widths: the blocks' dims and every param leaf's name,
    shape and dtype, against the reference's eval_shape."""
    for name, block, init in (("zamba2-2.7b", "mamba2", "mamba2_init"),
                              ("xlstm-1.3b", "mlstm", "mlstm_init"),
                              ("xlstm-1.3b", "slstm", "slstm_init")):
        jcfg, cfg = jget_arch(name), get_arch(name)
        want = jax.eval_shape(lambda: getattr(jssm, init)(
            jax.random.key(0), jcfg, jnp.bfloat16))
        got = getattr(ssm, init)(None, cfg, torch.bfloat16, "meta")
        flat = leaves(want)
        assert [n for n, _ in leaves(got)] == [n for n, _ in flat]
        for (n, g), (_, w) in zip(leaves(got), flat):
            assert tuple(g.shape) == w.shape, (block, n)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (block, n)
    assert ssm.mamba2_dims(get_arch("zamba2-2.7b")) == \
        jssm.mamba2_dims(jget_arch("zamba2-2.7b"))
    assert ssm.mlstm_dims(get_arch("xlstm-1.3b")) == \
        jssm.mlstm_dims(jget_arch("xlstm-1.3b"))
