"""The port's models (``repro_torch.models``) against the JAX package.

For the ``reduced()`` config of each of the six ``dense`` / ``moe`` archs,
the same params (the reference's ``init_params``, carried over with
``params_from_numpy``) and the same numpy tokens go through both packages
on the CPU. Reduced configs are f32. Logits are held to
``rtol = atol = 1e-4``: the reference's prefill runs a chunked online
softmax and XLA sums in another order, so the two differ in the last bits
of f32; greedy tokens must be identical. Data movement that involves no
arithmetic (MoE routing indices, param leaf names and shapes) is compared
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import get_arch as jget_arch
from repro.models import list_archs as jlist_archs
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch.models import attention, get_arch, layers, list_archs, moe
from repro_torch.models import transformer as tt
from repro_torch.serve import ServeEngine
from repro_torch.tree import leaves, params_from_numpy, params_to_numpy

from .test_torch_kernels import assert_same_bytes

RTOL = ATOL = 1e-4
CPU = "cpu"
PORTED = ["glm4-9b", "granite-3-8b", "granite-moe-1b-a400m", "h2o-danube-3-4b",
          "mixtral-8x22b", "phi3-mini-3.8b"]
UNPORTED = ["llama-3.2-vision-11b", "whisper-tiny", "xlstm-1.3b",
            "zamba2-2.7b"]


def cfgs(name):
    """(reference config, port config), reduced."""
    return jget_arch(name).reduced(), get_arch(name).reduced()


def same_params(cfg, seed=0):
    """(the reference's params, the port's copy on the CPU)."""
    p = jt.init_params(cfg, jax.random.key(seed))
    return p, params_from_numpy(jax.tree.map(np.asarray, p), CPU)


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def jitted(cfg):
    """The reference's prefill and decode step, jitted once per test (the
    reference engine jits them too): (prefill, decode_step)."""
    return (jax.jit(lambda p, tok, c: jt.prefill(p, cfg, tok, c)),
            jax.jit(lambda p, tok, c: jt.decode_step(p, cfg, tok, c)))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_configs_are_a_copy():
    assert list_archs() == jlist_archs()
    for name in list_archs():
        assert dataclasses.asdict(get_arch(name)) == \
            dataclasses.asdict(jget_arch(name))
        assert dataclasses.asdict(get_arch(name).reduced()) == \
            dataclasses.asdict(jget_arch(name).reduced())


@pytest.mark.parametrize("name", PORTED)
def test_param_tree_names_shapes_dtypes_match_at_full_size(name):
    """Published widths on the meta device against the reference's
    eval_shape: same leaf names, shapes, dtypes; same counts."""
    jcfg, cfg = jget_arch(name), get_arch(name)
    cfg = dataclasses.replace(cfg, n_layers=2)
    jcfg = dataclasses.replace(jcfg, n_layers=2)
    want = jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.key(0)))
    got = tt.init_params(cfg, device="meta")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    names_w = ["/".join(str(k.key) for k in path) for path, _ in flat_w]
    assert [n for n, _ in leaves(got)] == names_w
    for (_, g), (_, w) in zip(leaves(got), flat_w):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert tt.param_count(got) == jt.param_count(want)
    assert tt.active_param_count(got, cfg) == jt.active_param_count(want, jcfg)


@pytest.mark.parametrize("name", PORTED)
def test_forward_logits_match(name):
    jcfg, cfg = cfgs(name)
    jp, tp = same_params(jcfg)
    tok = tokens(jcfg, (2, 24))
    lj, _, aux_j = jt.forward(jp, jcfg, jnp.asarray(tok))
    lt, _, aux_t = tt.forward(tp, cfg, torch.from_numpy(tok).long())
    close(lt, lj)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=RTOL)


@pytest.mark.parametrize("name", PORTED)
def test_prefill_then_greedy_decode_matches(name):
    jcfg, cfg = cfgs(name)
    jp, tp = same_params(jcfg, seed=1)
    tok = tokens(jcfg, (2, 7), seed=1)
    cj = jt.init_caches(jcfg, 2, 32)
    ct = tt.init_caches(cfg, 2, 32, device=CPU)
    jprefill, jdecode = jitted(jcfg)
    lj, cj, _ = jprefill(jp, jnp.asarray(tok), cj)
    lt, ct, _ = tt.prefill(tp, cfg, torch.from_numpy(tok).long(), ct)
    close(lt, lj)
    nj, nt = np.asarray(jnp.argmax(lj[:, -1], -1)), lt[:, -1].argmax(-1)
    greedy_j, greedy_t = [nj], [nt.numpy()]
    for _ in range(4):
        lj, cj, _ = jdecode(jp, jnp.asarray(nj[:, None]), cj)
        lt, ct, _ = tt.decode_step(tp, cfg, nt[:, None], ct)
        close(lt, lj)
        nj, nt = np.asarray(jnp.argmax(lj[:, 0], -1)), lt[:, 0].argmax(-1)
        greedy_j.append(nj)
        greedy_t.append(nt.numpy())
    np.testing.assert_array_equal(np.stack(greedy_t), np.stack(greedy_j))
    np.testing.assert_array_equal(ct["index"].numpy(), np.asarray(cj["index"]))
    close(ct["blocks"].k, cj["blocks"].k)
    close(ct["blocks"].v, cj["blocks"].v)


@pytest.mark.parametrize("name", PORTED)
def test_per_slot_decode_with_ragged_index(name):
    """Continuous batching's decode: every slot at its own length."""
    jcfg, cfg = cfgs(name)
    jp, tp = same_params(jcfg, seed=2)
    tok = tokens(jcfg, (3, 9), seed=2)
    cj = jt.init_caches(jcfg, 3, 24)
    ct = tt.init_caches(cfg, 3, 24, device=CPU)
    jprefill, jdecode = jitted(jcfg)
    _, cj, _ = jprefill(jp, jnp.asarray(tok), cj)
    _, ct, _ = tt.prefill(tp, cfg, torch.from_numpy(tok).long(), ct)
    ragged = np.array([9, 4, 7], np.int32)
    cj = dict(cj, index=jnp.asarray(ragged))
    ct = dict(ct, index=torch.from_numpy(ragged))
    step = tokens(jcfg, (3, 1), seed=3)
    for _ in range(3):
        lj, cj, _ = jdecode(jp, jnp.asarray(step), cj)
        lt, ct, _ = tt.decode_step(tp, cfg, torch.from_numpy(step).long(), ct)
        close(lt, lj)
        step = np.asarray(jnp.argmax(lj[:, 0], -1))[:, None].astype(np.int32)
    np.testing.assert_array_equal(ct["index"].numpy(), ragged + 3)
    close(ct["blocks"].k, cj["blocks"].k)


@pytest.mark.parametrize("name,max_len", [
    ("h2o-danube-3-4b", 16),    # ring: a window-sized cache
    ("h2o-danube-3-4b", 40),    # a longer cache, masked to the window
    ("mixtral-8x22b", 12),      # ring below the window, with MoE
])
def test_windowed_decode_past_the_window(name, max_len):
    jcfg, cfg = cfgs(name)
    assert cfg.window == 16
    jp, tp = same_params(jcfg, seed=4)
    tok = tokens(jcfg, (2, 6), seed=4)
    cj = jt.init_caches(jcfg, 2, max_len)
    ct = tt.init_caches(cfg, 2, max_len, device=CPU)
    jprefill, jdecode = jitted(jcfg)
    lj, cj, _ = jprefill(jp, jnp.asarray(tok), cj)
    lt, ct, _ = tt.prefill(tp, cfg, torch.from_numpy(tok).long(), ct)
    nj = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(np.int32)
    for _ in range(22):  # to position 28: past the window (and the ring)
        lj, cj, _ = jdecode(jp, jnp.asarray(nj), cj)
        lt, ct, _ = tt.decode_step(tp, cfg, torch.from_numpy(nj).long(), ct)
        close(lt, lj)
        nj = np.asarray(jnp.argmax(lj[:, 0], -1))[:, None].astype(np.int32)
        assert np.array_equal(lt[:, 0].argmax(-1).numpy(), nj[:, 0])


def test_one_token_prefill_takes_the_decode_branch():
    jcfg, cfg = cfgs("granite-3-8b")
    jp, tp = same_params(jcfg, seed=5)
    tok = tokens(jcfg, (2, 1), seed=5)
    lj, cj, _ = jt.prefill(jp, jcfg, jnp.asarray(tok), jt.init_caches(jcfg, 2, 8))
    lt, ct, _ = tt.prefill(tp, cfg, torch.from_numpy(tok).long(),
                           tt.init_caches(cfg, 2, 8, device=CPU))
    close(lt, lj)
    close(ct["blocks"].k, cj["blocks"].k)


@pytest.mark.parametrize("use_rope", [False, True])
def test_cross_attention_matches(use_rope):
    jcfg, cfg = cfgs("granite-3-8b")
    rng = np.random.default_rng(6)
    p = jattn.attn_init(jax.random.key(6), jcfg, jnp.float32)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5), (2, 5))
    want, _ = jattn.attn_apply(p, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                               kv_x=jnp.asarray(kv), causal=False,
                               use_rope=use_rope)
    got, _ = attention.attn_apply(params_from_numpy(
        jax.tree.map(np.asarray, p), CPU), torch.from_numpy(x), cfg,
        positions=torch.from_numpy(pos.copy()), kv_x=torch.from_numpy(kv),
        causal=False, use_rope=use_rope)
    close(got, want)


def test_layers_match_in_bf16():
    """rmsnorm (f32 inside), rope (f32 angles) and unembed (f32 logits) on
    bf16 inputs: the reference's rounding points."""
    rng = np.random.default_rng(7)
    bf = jnp.bfloat16
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 9), (2, 6))
    xj = jnp.asarray(x, bf)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = jlayers.rope(xj, jnp.asarray(pos), 10_000.0)
    got = layers.rope(xt, torch.from_numpy(pos.copy()), 10_000.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale, bf)}, jnp.asarray(h, bf))
    got = layers.rmsnorm({"scale": torch.from_numpy(scale).bfloat16()},
                         torch.from_numpy(h).bfloat16())
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)
    w = rng.standard_normal((64, 50)).astype(np.float32)
    want = jlayers.unembed(jnp.asarray(w, bf), jnp.asarray(h, bf), tied=False)
    got = layers.unembed(torch.from_numpy(w).bfloat16(),
                         torch.from_numpy(h).bfloat16(), tied=False)
    assert got.dtype == torch.float32
    close(got, want)


# ---------------------------------------------------------------------------
# MoE routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_top_k_breaks_ties_as_jax(k):
    rng = np.random.default_rng(8)
    # probabilities drawn from a few levels: many exact ties per row
    x = rng.integers(0, 4, (64, 32)).astype(np.float32) / 4
    vals, idx = moe.top_k(torch.from_numpy(x), k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("name,tied", [
    ("granite-moe-1b-a400m", False), ("granite-moe-1b-a400m", True),
    ("mixtral-8x22b", False), ("mixtral-8x22b", True)])
def test_moe_routing_and_output_match(name, tied):
    """Router indices equal ``jax.lax.top_k``'s; with a zero router every
    probability ties, every token picks the lowest experts, and capacity
    drops the overflow, in both packages alike."""
    jcfg, cfg = cfgs(name)
    rng = np.random.default_rng(9)
    p = jmoe.moe_init(jax.random.key(9), jcfg, jnp.float32)
    if tied:
        p = dict(p, w_router=jnp.zeros_like(p["w_router"]))
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, p), CPU)
    probs, _, idx = moe.route(tp, torch.from_numpy(x), cfg)
    _, jidx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x) @ p["w_router"], axis=-1), jcfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if tied:
        assert (idx.numpy() == np.arange(jcfg.top_k)).all()
    want, aux_j = jmoe.moe_apply(p, jnp.asarray(x), jcfg)
    got, aux_t = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    close(got, want)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=RTOL)
    assert moe.moe_capacity(cfg, 12) == jmoe.moe_capacity(jcfg, 12)


# ---------------------------------------------------------------------------
# carrying params across, unported families
# ---------------------------------------------------------------------------

def test_params_round_trip_to_numpy_keeps_bytes_bf16():
    jcfg = dataclasses.replace(jget_arch("granite-3-8b").reduced(),
                               dtype="bfloat16")
    p = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.key(10)))
    tp = params_from_numpy(p, CPU)
    assert tp["embed"].dtype == torch.bfloat16
    back = params_to_numpy(tp)
    for (n1, a), (n2, b) in zip(leaves(p), leaves(back)):
        assert n1 == n2
        assert_same_bytes(b, a)


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_families_raise(name):
    cfg = get_arch(name).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1"):
        tt.init_params(cfg, device="meta")
    with pytest.raises(NotImplementedError, match=cfg.family):
        tt.init_caches(cfg, 1, 8, device=CPU)
    with pytest.raises(NotImplementedError):
        tt.forward({"embed": torch.zeros(cfg.vocab_size, cfg.d_model)}, cfg,
                   torch.zeros((1, 2), dtype=torch.long))
    with pytest.raises(NotImplementedError):
        ServeEngine({"embed": torch.zeros(1)}, cfg, n_slots=1, max_len=8)
