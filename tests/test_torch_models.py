"""The port's models (``repro_torch.models``) against the JAX package.

For the ``reduced()`` config of each of the ten archs (every family:
``dense``, ``moe``, ``vlm``, ``audio``, ``hybrid``, ``ssm``), the same
params (the reference's ``init_params``, carried over with
``params_from_numpy``), the same numpy tokens and the same stub-frontend
inputs (``image_embeds``, ``encoder_frames``) go through both packages on
the CPU. Reduced configs are f32. Logits and cache leaves are held to
``rtol = atol = 1e-4``: the reference's prefill runs a chunked online
softmax and XLA sums in another order, so the two differ in the last bits
of f32; greedy tokens must be identical. Data movement that involves no
arithmetic (MoE routing indices, param and cache leaf names and shapes,
cache indices) is compared exactly. Prompts of the ssm and hybrid families
are multiples of, or shorter than, ``ssm_chunk`` (8 when reduced), as
their chunked core requires in both packages.
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
from repro_torch.tree import leaves, params_from_numpy, params_to_numpy, to_numpy

from .test_torch_kernels import assert_same_bytes

RTOL = ATOL = 1e-4
CPU = "cpu"
ALL = ["glm4-9b", "granite-3-8b", "granite-moe-1b-a400m", "h2o-danube-3-4b",
       "llama-3.2-vision-11b", "mixtral-8x22b", "phi3-mini-3.8b",
       "whisper-tiny", "xlstm-1.3b", "zamba2-2.7b"]
ENC_LEN = 12   # encoder frames of the reduced whisper in these tests


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


def extras(cfg, b, seed=0):
    """The stub frontends' inputs of ``cfg``'s family, b rows each: (for
    the reference, for the port, for decode steps of the reference, for
    decode steps of the port). An audio decode step reads the encoder
    states from the caches."""
    rng = np.random.default_rng(seed + 100)
    kw = {}
    if cfg.family == "vlm":
        kw["image_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        kw["encoder_frames"] = rng.standard_normal(
            (b, ENC_LEN, cfg.d_model)).astype(np.float32)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    dec = ("image_embeds",)
    return (jkw, tkw, {k: v for k, v in jkw.items() if k in dec},
            {k: v for k, v in tkw.items() if k in dec})


def jitted(cfg):
    """The reference's prefill and decode step, jitted once per test (the
    reference engine jits them too): (prefill, decode_step), each called
    as ``fn(params, tokens, caches[, extra_inputs])``."""
    return (jax.jit(lambda p, tok, c, kw=None: jt.prefill(
                p, cfg, tok, c, **(kw or {}))),
            jax.jit(lambda p, tok, c, kw=None: jt.decode_step(
                p, cfg, tok, c, **(kw or {}))))


def close(got, want):
    np.testing.assert_allclose(to_numpy(got.detach()), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def close_caches(got, want):
    """Every cache leaf: names and dtypes equal, the index exactly, the
    rest within the tolerance."""
    g, w = leaves(got), leaves(jax.tree.map(np.asarray, want))
    assert [n for n, _ in g] == [n for n, _ in w]
    for (n, a), (_, b) in zip(g, w):
        assert str(to_numpy(a).dtype) == str(b.dtype), n
        if n == "index":
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            close(a, b)


def test_configs_are_a_copy():
    assert list_archs() == jlist_archs()
    for name in list_archs():
        assert dataclasses.asdict(get_arch(name)) == \
            dataclasses.asdict(jget_arch(name))
        assert dataclasses.asdict(get_arch(name).reduced()) == \
            dataclasses.asdict(jget_arch(name).reduced())


@pytest.mark.parametrize("name", ALL)
def test_param_tree_names_shapes_dtypes_match_at_full_size(name):
    """Published widths and depth on the meta device against the
    reference's eval_shape: same leaf names, shapes, dtypes; same counts;
    the same cache tree (4 slots of 256 positions, 1500 encoder states)."""
    jcfg, cfg = jget_arch(name), get_arch(name)
    assert tt.superblock_plan(cfg) == jt.superblock_plan(jcfg)
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
    want = jax.eval_shape(lambda: jt.init_caches(jcfg, 4, 256, enc_len=1500))
    got = tt.init_caches(cfg, 4, 256, enc_len=1500, device="meta")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [n for n, _ in leaves(got)] == [
        "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        for path, _ in flat_w]
    for (_, g), (_, w) in zip(leaves(got), flat_w):
        assert (tuple(g.shape), str(g.dtype).split(".")[-1]) == \
            (w.shape, str(w.dtype))


@pytest.mark.parametrize("name", ALL)
def test_forward_logits_match(name):
    jcfg, cfg = cfgs(name)
    jp, tp = same_params(jcfg)
    tok = tokens(jcfg, (2, 24))
    jkw, tkw, _, _ = extras(jcfg, 2)
    lj, _, aux_j = jt.forward(jp, jcfg, jnp.asarray(tok), **jkw)
    lt, _, aux_t = tt.forward(tp, cfg, torch.from_numpy(tok).long(), **tkw)
    close(lt, lj)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=RTOL)


@pytest.mark.parametrize("name", ALL)
def test_prefill_then_greedy_decode_matches(name):
    jcfg, cfg = cfgs(name)
    jp, tp = same_params(jcfg, seed=1)
    tok = tokens(jcfg, (2, 7), seed=1)
    jkw, tkw, jdkw, tdkw = extras(jcfg, 2, seed=1)
    cj = jt.init_caches(jcfg, 2, 32, enc_len=ENC_LEN)
    ct = tt.init_caches(cfg, 2, 32, enc_len=ENC_LEN, device=CPU)
    jprefill, jdecode = jitted(jcfg)
    lj, cj, _ = jprefill(jp, jnp.asarray(tok), cj, jkw)
    lt, ct, _ = tt.prefill(tp, cfg, torch.from_numpy(tok).long(), ct, **tkw)
    close(lt, lj)
    nj, nt = np.asarray(jnp.argmax(lj[:, -1], -1)), lt[:, -1].argmax(-1)
    greedy_j, greedy_t = [nj], [nt.numpy()]
    for _ in range(4):
        lj, cj, _ = jdecode(jp, jnp.asarray(nj[:, None]), cj, jdkw)
        lt, ct, _ = tt.decode_step(tp, cfg, nt[:, None], ct, **tdkw)
        close(lt, lj)
        nj, nt = np.asarray(jnp.argmax(lj[:, 0], -1)), lt[:, 0].argmax(-1)
        greedy_j.append(nj)
        greedy_t.append(nt.numpy())
    np.testing.assert_array_equal(np.stack(greedy_t), np.stack(greedy_j))
    close_caches(ct, cj)


@pytest.mark.parametrize("name", ALL)
def test_per_slot_decode_with_ragged_index(name):
    """Continuous batching's decode: every slot at its own length."""
    jcfg, cfg = cfgs(name)
    jp, tp = same_params(jcfg, seed=2)
    t = 8 if cfg.family in ("ssm", "hybrid") else 9   # a whole ssm chunk
    tok = tokens(jcfg, (3, t), seed=2)
    jkw, tkw, jdkw, tdkw = extras(jcfg, 3, seed=2)
    cj = jt.init_caches(jcfg, 3, 24, enc_len=ENC_LEN)
    ct = tt.init_caches(cfg, 3, 24, enc_len=ENC_LEN, device=CPU)
    jprefill, jdecode = jitted(jcfg)
    _, cj, _ = jprefill(jp, jnp.asarray(tok), cj, jkw)
    _, ct, _ = tt.prefill(tp, cfg, torch.from_numpy(tok).long(), ct, **tkw)
    ragged = np.array([t, 4, 7], np.int32)
    cj = dict(cj, index=jnp.asarray(ragged))
    ct = dict(ct, index=torch.from_numpy(ragged))
    step = tokens(jcfg, (3, 1), seed=3)
    for _ in range(3):
        lj, cj, _ = jdecode(jp, jnp.asarray(step), cj, jdkw)
        lt, ct, _ = tt.decode_step(tp, cfg, torch.from_numpy(step).long(), ct,
                                   **tdkw)
        close(lt, lj)
        step = np.asarray(jnp.argmax(lj[:, 0], -1))[:, None].astype(np.int32)
    np.testing.assert_array_equal(ct["index"].numpy(), ragged + 3)
    close_caches(ct, cj)


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


@pytest.mark.parametrize("name", ALL)
def test_one_token_prefill_takes_the_decode_branch(name):
    jcfg, cfg = cfgs(name)
    jp, tp = same_params(jcfg, seed=5)
    tok = tokens(jcfg, (2, 1), seed=5)
    jkw, tkw, _, _ = extras(jcfg, 2, seed=5)
    lj, cj, _ = jt.prefill(jp, jcfg, jnp.asarray(tok),
                           jt.init_caches(jcfg, 2, 8, enc_len=ENC_LEN), **jkw)
    lt, ct, _ = tt.prefill(tp, cfg, torch.from_numpy(tok).long(),
                           tt.init_caches(cfg, 2, 8, enc_len=ENC_LEN,
                                          device=CPU), **tkw)
    close(lt, lj)
    close_caches(ct, cj)


@pytest.mark.parametrize("name", ["glm4-9b", "zamba2-2.7b", "xlstm-1.3b"])
def test_decode_matches_forward(name):
    """Teacher-forced decode reproduces the parallel forward's logits (the
    reference's test of the same name, on the port, at its tolerance), and
    the decoded logits are the reference's."""
    jcfg, cfg = cfgs(name)
    jp, tp = same_params(jcfg, seed=2)
    tok = tokens(jcfg, (1, 8), seed=2)
    full, _, _ = tt.forward(tp, cfg, torch.from_numpy(tok).long())
    ct = tt.init_caches(cfg, 1, 16, device=CPU)
    _, ct, _ = tt.prefill(tp, cfg, torch.from_numpy(tok[:, :4]).long(), ct)
    cj = jt.init_caches(jcfg, 1, 16)
    _, cj, _ = jt.prefill(jp, jcfg, jnp.asarray(tok[:, :4]), cj)
    outs = []
    for i in range(4, 8):
        lt, ct, _ = tt.decode_step(tp, cfg,
                                   torch.from_numpy(tok[:, i:i + 1]).long(), ct)
        lj, cj, _ = jt.decode_step(jp, jcfg, jnp.asarray(tok[:, i:i + 1]), cj)
        close(lt, lj)
        outs.append(lt)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               full[:, 4:8].numpy(), rtol=2e-2, atol=2e-2)


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
# carrying params across, families
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


def test_unknown_family_raises():
    """A family no code path knows raises ``ValueError``, as the
    reference's ``init_params`` does."""
    cfg = dataclasses.replace(get_arch("granite-3-8b").reduced(),
                              family="rnn")
    with pytest.raises(ValueError, match="unknown family rnn"):
        jt.init_params(dataclasses.replace(jget_arch("granite-3-8b").reduced(),
                                           family="rnn"), jax.random.key(0))
    with pytest.raises(ValueError, match="unknown family rnn"):
        tt.init_params(cfg, device="meta")
    with pytest.raises(ValueError, match="unknown family rnn"):
        tt.init_caches(cfg, 1, 8, device=CPU)
    params = tt.init_params(get_arch("granite-3-8b").reduced(), device=CPU)
    with pytest.raises(ValueError, match="unknown family rnn"):
        tt.forward(params, cfg, torch.zeros((1, 2), dtype=torch.long))
    with pytest.raises(ValueError, match="unknown family rnn"):
        ServeEngine(params, cfg, n_slots=1, max_len=8)


@pytest.mark.parametrize("name,missing", [("llama-3.2-vision-11b",
                                           "image_embeds"),
                                          ("whisper-tiny", "encoder_frames")])
def test_stub_frontend_inputs_are_required(name, missing):
    """vlm without ``image_embeds`` raises; audio without
    ``encoder_frames`` raises unless its caches hold ``enc_out``."""
    cfg = get_arch(name).reduced()
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    tok = torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(ValueError, match=missing):
        tt.forward(params, cfg, tok)
    if cfg.family == "audio":
        caches = tt.init_caches(cfg, 1, 8, enc_len=3, device=CPU)
        logits, _, _ = tt.prefill(params, cfg, tok, caches)
        assert logits.shape == (1, 2, cfg.vocab_size)
