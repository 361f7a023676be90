"""The port's gradient-compression path (``repro_torch``) against the JAX package.

The two new kernels' plain PyTorch versions (``block_norms``,
``block_scatter``), the ``block_topk`` glue, the device codecs of
``core/device.py`` and ``compressed_grad_mean`` with error feedback, all on
the CPU, each held to the JAX oracle (``repro.kernels.ref``), the Pallas
kernel in interpret mode (``repro.kernels.ops.*(use_pallas=True)``, as
``tests/test_kernels.py`` runs it) and the reference's own functions, on
the same numpy inputs. The CUDA kernels run only on the card, where
``chip_smoke.py`` holds them to these plain versions.

Tolerances: data movement (gather, scatter, ids, blocks, residuals) is
compared byte for byte. Norms on random data are sums of positive f32
terms in another order than XLA's, held to ``NORM_RTOL``; norms of dyadic
data (small integers / 8) are exact in any order and compared exactly. The
pod mean is held to ``MEAN_RTOL`` (XLA and torch may sum pods in another
order).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import device as jdev
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.train import grad_compress as jgc
from repro_torch.core import device as dev
from repro_torch.kernels import block_norms, block_scatter, ops
from repro_torch.lake.device import to_torch
from repro_torch.train import grad_compress as gc

from .test_encodings import sparse_tensor
from .test_kernels import SHAPES_BLOCKS
from .test_torch_kernels import as_numpy, assert_same_bytes, mk

NORM_RTOL = 1e-6
MEAN_RTOL = 1e-6
CPU = "cpu"
RNG = np.random.default_rng(43)


def t(x):
    """numpy -> CPU tensor with the same bytes."""
    return to_torch(np.asarray(x), CPU)


def blocked_view(x, bs):
    """The reference's (G, bh*bw) blocked view of 2-D ``x``, zero-padded."""
    bh, bw = bs
    m, n = x.shape
    gh, gw = -(-m // bh), -(-n // bw)
    xp = np.zeros((gh * bh, gw * bw), x.dtype)
    xp[:m, :n] = x
    return xp.reshape(gh, bh, gw, bw).transpose(0, 2, 1, 3).reshape(gh * gw, bh * bw)


def dyadic(shape, seed):
    """Integers in [-3, 3] / 8: squares and their sums are exact in f32."""
    return (np.random.default_rng(seed).integers(-3, 4, shape) / 8).astype(np.float32)


# ---------------------------------------------------------------------------
# block_norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,b", [(8, 128), (16, 64), (3, 256), (40, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_norms_plain_on_blocked_view_matches_ref_and_pallas(g, b, dtype):
    bv = mk((g, b), dtype, seed=4)
    got = as_numpy(ops.block_norms(t(bv), (1, b)))
    want_ref = np.asarray(jref.block_norms(jnp.asarray(bv)))
    want_pallas = np.asarray(jops.block_norms(jnp.asarray(bv), use_pallas=True))
    assert got.dtype == np.float32 and got.shape == (g,)
    np.testing.assert_allclose(got, want_ref, rtol=NORM_RTOL, atol=0)
    np.testing.assert_allclose(got, want_pallas, rtol=NORM_RTOL, atol=0)


@pytest.mark.parametrize("shape,bs", SHAPES_BLOCKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_norms_plain_on_2d_operand_matches_ref_blocked_view(shape, bs, dtype):
    x = mk(shape, dtype, seed=5)
    got = as_numpy(ops.block_norms(t(x), bs))
    want = np.asarray(jref.block_norms(jnp.asarray(blocked_view(x, bs))))
    np.testing.assert_allclose(got, want, rtol=NORM_RTOL, atol=0)


@pytest.mark.parametrize("dtype", ["float16", "float64"])
def test_block_norms_casts_to_f32_before_squaring(dtype):
    x = mk((24, 200), dtype, seed=6)
    got = as_numpy(ops.block_norms(t(x), (8, 64)))
    xf = blocked_view(x.astype(np.float32), (8, 64)).astype(np.float64)
    np.testing.assert_allclose(got, (xf * xf).sum(1), rtol=NORM_RTOL, atol=0)


def test_block_norms_exact_on_dyadic_data():
    x = dyadic((37, 300), seed=7)
    got = as_numpy(ops.block_norms(t(x), (8, 128)))
    xf = blocked_view(x, (8, 128)).astype(np.float64)
    assert_same_bytes(got, (xf * xf).sum(1).astype(np.float32))
    want = np.asarray(jref.block_norms(jnp.asarray(blocked_view(x, (8, 128)))))
    assert_same_bytes(got, want)


# ---------------------------------------------------------------------------
# block_scatter
# ---------------------------------------------------------------------------

def _scatter_ids(n_blocks, k):
    ids = RNG.choice(n_blocks + 1, size=k, replace=False)  # n_blocks drops
    return ids.astype(np.int32)


@pytest.mark.parametrize("shape,bs", SHAPES_BLOCKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_block_scatter_plain_matches_ref_and_pallas(shape, bs, dtype):
    base = mk(shape, dtype, seed=2)
    gh, gw = -(-shape[0] // bs[0]), -(-shape[1] // bs[1])
    ids = _scatter_ids(gh * gw, min(gh * gw, 4))
    blocks = mk((len(ids),) + bs, dtype, seed=3)
    got = ops.block_scatter(t(base), t(ids), t(blocks))
    want_ref = jops.block_scatter(jnp.asarray(base), jnp.asarray(ids),
                                  jnp.asarray(blocks), use_pallas=False)
    want_pallas = jops.block_scatter(jnp.asarray(base), jnp.asarray(ids),
                                     jnp.asarray(blocks), use_pallas=True)
    assert_same_bytes(got, np.asarray(want_ref))
    assert_same_bytes(got, np.asarray(want_pallas))


@pytest.mark.parametrize("ids", [[-1, 0], [-4, 2], [-5, 1], [4, 9, 3]])
def test_block_scatter_negative_ids_wrap_and_out_of_range_drop(ids):
    # a 2 x 2 grid of (4, 8) tiles; -1 is the last tile, -5 drops
    base = mk((8, 16), "float32", seed=8)
    ids = np.asarray(ids, np.int32)
    blocks = mk((len(ids), 4, 8), "float32", seed=9)
    got = ops.block_scatter(t(base), t(ids), t(blocks))
    for use_pallas in (False, True):
        want = jops.block_scatter(jnp.asarray(base), jnp.asarray(ids),
                                  jnp.asarray(blocks), use_pallas=use_pallas)
        assert_same_bytes(got, np.asarray(want))


def test_block_scatter_casts_blocks_to_base_dtype():
    base = mk((16, 256), "bfloat16", seed=10)
    ids = np.asarray([3, 0], np.int32)
    blocks = mk((2, 8, 128), "float32", seed=11)
    got = ops.block_scatter(t(base), t(ids), t(blocks))
    want = jref.block_scatter(jnp.asarray(base), jnp.asarray(ids),
                              jnp.asarray(blocks))
    assert_same_bytes(got, np.asarray(want))
    assert got.dtype == torch.bfloat16


def test_block_scatter_in_place_writes_into_base():
    base = t(np.zeros((9, 130), np.float32))
    ids = t(np.asarray([0, 5], np.int32))
    blocks = t(mk((2, 4, 64), "float32", seed=12))
    want = ops.block_scatter(base, ids, blocks)
    got = ops.block_scatter(base, ids, blocks, inplace=True)
    assert got.data_ptr() == base.data_ptr()
    assert_same_bytes(base, want)
    with pytest.raises(ValueError, match="contiguous"):
        ops.block_scatter(base.t(), ids, blocks, inplace=True)


# ---------------------------------------------------------------------------
# block_topk glue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,bs,k", [((32, 256), (8, 128), 3),
                                        ((9, 130), (4, 64), 4),
                                        ((64, 128), (1, 128), 10)])
def test_block_topk_matches_ref_and_pallas(shape, bs, k):
    x = mk(shape, "float32", seed=6)
    ids, blocks = ops.block_topk(t(x), bs, k)
    gh, gw = -(-shape[0] // bs[0]), -(-shape[1] // bs[1])
    padded = np.zeros((gh * bs[0], gw * bs[1]), np.float32)  # ref wants whole tiles
    padded[:shape[0], :shape[1]] = x
    ids_r, blk_r = jref.block_topk(jnp.asarray(padded), bs, k)
    assert_same_bytes(ids, np.asarray(ids_r))
    assert_same_bytes(blocks, np.asarray(blk_r))
    ids_p, blk_p = jops.block_topk(jnp.asarray(x), bs, k, use_pallas=True)
    assert_same_bytes(ids, np.asarray(ids_p))
    assert_same_bytes(blocks, np.asarray(blk_p))


def test_block_topk_ties_take_the_lower_id_first():
    zeros = np.zeros((32, 256), np.float32)
    ids, _ = ops.block_topk(t(zeros), (8, 128), 3)
    assert as_numpy(ids).tolist() == [0, 1, 2]
    want, _ = jref.block_topk(jnp.asarray(zeros), (8, 128), 3)
    assert np.asarray(want).tolist() == [0, 1, 2]
    # equal non-zero norms among others: lower ids first, as jax.lax.top_k
    x = np.zeros((16, 512), np.float32)
    x[0:8, 384:512] = 1.0   # tile 3
    x[8:16, 0:128] = 1.0    # tile 4, same norm
    x[0:8, 128:256] = 2.0   # tile 1, largest
    ids, _ = ops.block_topk(t(x), (8, 128), 4)
    want, _ = jref.block_topk(jnp.asarray(x), (8, 128), 4)
    assert as_numpy(ids).tolist() == np.asarray(want).tolist() == [1, 3, 4, 0]


# ---------------------------------------------------------------------------
# core/device.py: the scenarios of tests/test_device_codecs.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16,), (8, 12), (4, 6, 10)])
def test_coo_roundtrip_matches_ref(shape):
    x = sparse_tensor(shape, density=0.2, seed=1)
    cap = int(np.prod(shape))
    coo = dev.coo_encode(t(x), capacity=cap)
    want = jdev.coo_encode(jnp.asarray(x), capacity=cap)
    for got_f, want_f in zip(coo, want):
        assert_same_bytes(got_f, np.asarray(want_f))
    assert_same_bytes(dev.coo_decode(coo, shape), x)
    assert int(coo.nnz) == np.count_nonzero(x)


def test_coo_capacity_truncates_gracefully():
    x = np.ones((8, 8), dtype=np.float32)
    coo = dev.coo_encode(t(x), capacity=10)
    assert int(coo.nnz) == 10
    out = as_numpy(dev.coo_decode(coo, (8, 8)))
    assert np.count_nonzero(out) == 10
    want = jdev.coo_decode(jdev.coo_encode(jnp.asarray(x), capacity=10), (8, 8))
    assert_same_bytes(out, np.asarray(want))


def test_coo_decode_overwrites_duplicates_instead_of_adding():
    coo = dev.DeviceCOO(t(np.asarray([2, 2, 16], np.int32)),
                        t(np.asarray([5.0, 5.0, 1.0], np.float32)),
                        t(np.asarray(2, np.int32)))
    out = as_numpy(dev.coo_decode(coo, (4, 4)))
    assert out[0, 2] == 5.0 and out.sum() == 5.0  # index 16 is padding


@pytest.mark.parametrize("shape,bs", [((16, 16), (4, 4)), ((6, 9), (2, 3)),
                                      ((5, 7), (2, 2)), ((4, 4, 8), (2, 2, 4))])
def test_blockify_roundtrip_matches_ref(shape, bs):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    bv = dev.blockify(t(x), bs)
    assert_same_bytes(bv, np.asarray(jdev.blockify(jnp.asarray(x), bs)))
    assert_same_bytes(dev.unblockify(bv, shape, bs), x)


@pytest.mark.parametrize("shape,bs", [((16, 16), (4, 4)), ((10, 9), (3, 3)),
                                      ((4, 6, 8), (2, 3, 4)), ((5, 7, 3), (2, 2, 2))])
def test_bsgs_roundtrip_matches_ref(shape, bs):
    x = sparse_tensor(shape, density=0.1, seed=2)
    grid = tuple(-(-s // b) for s, b in zip(shape, bs))
    cap = int(np.prod(grid))
    db = dev.bsgs_encode(t(x), bs, capacity=cap)
    want = jdev.bsgs_encode(jnp.asarray(x), bs, capacity=cap)
    for got_f, want_f in zip(db, want):
        assert_same_bytes(got_f, np.asarray(want_f))
    assert_same_bytes(dev.bsgs_decode(db, shape, bs), x)


def test_bsgs_topk_keeps_highest_energy():
    x = np.zeros((8, 8), dtype=np.float32)
    x[0:2, 0:2] = 10.0
    x[4:6, 4:6] = 5.0
    x[6:8, 0:2] = 0.1
    db = dev.bsgs_topk(t(x), (2, 2), k=2)
    out = as_numpy(dev.bsgs_decode(db, (8, 8), (2, 2)))
    assert out[0, 0] == 10.0 and out[4, 4] == 5.0 and out[6, 0] == 0.0
    assert np.abs(x - out).max() == pytest.approx(0.1)
    want = jdev.bsgs_topk(jnp.asarray(x), (2, 2), k=2)
    assert_same_bytes(db.block_ids, np.asarray(want.block_ids))
    assert_same_bytes(db.blocks, np.asarray(want.blocks))
    assert dev.compression_ratio(db, (8, 8)) == pytest.approx(
        jdev.compression_ratio(want, (8, 8)))


def test_bsgs_topk_over_an_explicit_batch_dim_matches_ref_vmap():
    xs = np.random.default_rng(3).standard_normal((4, 8, 8)).astype(np.float32)
    got = torch.stack([dev.bsgs_topk(x, (2, 2), k=3).blocks for x in t(xs)])
    want = jax.vmap(lambda x: jdev.bsgs_topk(x, (2, 2), k=3).blocks)(
        jnp.asarray(xs))
    assert got.shape == (4, 3, 4)
    assert_same_bytes(got, np.asarray(want))


@pytest.mark.parametrize("shape,bs,k", [((10, 9), (3, 4), 4), ((16, 256), (8, 128), 3),
                                        ((4, 6, 8), (2, 3, 4), 5),
                                        ((5, 7, 3), (2, 2, 2), 6)])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_bsgs_topk_and_decode_match_ref(shape, bs, k, dtype):
    """2-D through the kernels' routes, N-D plain; ragged edges included."""
    x = dyadic(shape, seed=14).astype(dtype)
    got = dev.bsgs_topk(t(x), bs, k=k)
    want = jdev.bsgs_topk(jnp.asarray(x), bs, k=k)
    for got_f, want_f in zip(got, want):
        assert_same_bytes(got_f, np.asarray(want_f))
    assert_same_bytes(dev.bsgs_decode(got, shape, bs),
                      np.asarray(jdev.bsgs_decode(want, shape, bs)))


def test_bsgs_2d_goes_through_the_kernel_entry_points(monkeypatch):
    calls = []
    for name in ("block_topk", "block_scatter"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    x = t(dyadic((12, 20), seed=15))
    db = dev.bsgs_topk(x, (4, 4), k=3)
    dev.bsgs_decode(db, (12, 20), (4, 4))
    assert calls == ["block_topk", "block_scatter"]
    dev.bsgs_decode(dev.bsgs_topk(t(dyadic((4, 4, 4), seed=16)), (2, 2, 2), k=2),
                    (4, 4, 4), (2, 2, 2))
    assert calls == ["block_topk", "block_scatter"]  # N-D stays plain


def test_bsgs_topk_ties_match_ref():
    x = dyadic((6, 10), seed=13)  # many equal block energies
    got = dev.bsgs_topk(t(x), (2, 2), k=7)
    want = jdev.bsgs_topk(jnp.asarray(x), (2, 2), k=7)
    assert_same_bytes(got.block_ids, np.asarray(want.block_ids))
    assert_same_bytes(got.blocks, np.asarray(want.blocks))


# ---------------------------------------------------------------------------
# compressed_grad_mean with error feedback
# ---------------------------------------------------------------------------

TREE = {"w": (2, 32, 256), "b": (2, 40), "stack": (2, 3, 20, 130)}


def _grads(step, dtype):
    rng = np.random.default_rng(100 + step)
    out = {}
    for name, shape in TREE.items():
        g = 0.03 * rng.standard_normal(shape)
        g[..., :3, :] += rng.standard_normal(g[..., :3, :].shape)  # hot rows
        out[name] = g.astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                             else np.float32)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ratio", [0.1, 0.25])
@pytest.mark.parametrize("block", [(8, 128), (1, 128)])
def test_compressed_grad_mean_matches_ref_over_three_steps(dtype, ratio, block):
    r_ref = jgc.init_residuals({k: jnp.zeros(s) for k, s in TREE.items()})
    r_port = gc.init_residuals({k: torch.zeros(s) for k, s in TREE.items()})
    for step in range(3):
        g = _grads(step, dtype)
        g_ref = {k: jnp.asarray(v) for k, v in g.items()}
        g_port = {k: t(v) for k, v in g.items()}
        mean, new_r, stats = gc.compressed_grad_mean(
            g_port, r_port, ratio=ratio, block=block, with_payload=True)
        mean_ref, new_r_ref, stats_ref = jgc.compressed_grad_mean(
            g_ref, r_ref, ratio=ratio, block=block)
        for name in TREE:
            e = g_ref[name].astype(jnp.float32) + r_ref[name]
            ids_ref, blocks_ref, *_ = jgc._compress_leaf(e, ratio, block)
            ids, blocks = stats["payload"][name]
            assert_same_bytes(ids, np.asarray(ids_ref))
            assert_same_bytes(blocks, np.asarray(blocks_ref))
            assert_same_bytes(new_r[name], np.asarray(new_r_ref[name]))
            np.testing.assert_allclose(as_numpy(mean[name]),
                                       np.asarray(mean_ref[name]),
                                       rtol=MEAN_RTOL, atol=0)
        assert (stats["sent_bytes"], stats["dense_bytes"]) == \
            (stats_ref["sent_bytes"], stats_ref["dense_bytes"])
        assert gc.compression_ratio_bytes(stats) == \
            jgc.compression_ratio_bytes(stats_ref)
        # carry the reference's error feedback into both packages
        r_ref = new_r_ref
        r_port = gc.residuals_from_numpy(jax.tree.map(np.asarray, new_r_ref),
                                         CPU)


def test_error_feedback_accumulates_dropped_blocks():
    g = np.random.default_rng(2).standard_normal((1, 32, 256)).astype(np.float32)
    mean, new_r, stats = gc.compressed_grad_mean(
        {"w": t(g)}, {"w": torch.zeros(g.shape)}, ratio=0.1)
    # decoded + residual == original (lossless decomposition)
    np.testing.assert_allclose(as_numpy(mean["w"] + new_r["w"][0]), g[0],
                               atol=1e-5)
    assert gc.compression_ratio_bytes(stats) < 0.2


def test_compressed_grad_mean_returns_the_payload_only_when_asked():
    g = {"w": t(mk((2, 16, 256), "float32", seed=23)),
         "b": t(mk((2, 40), "float32", seed=24))}
    r = gc.init_residuals(g)
    _, _, stats = gc.compressed_grad_mean(g, r, ratio=0.25)
    assert set(stats) == {"sent_bytes", "dense_bytes"}
    _, _, stats = gc.compressed_grad_mean(g, r, ratio=0.25, with_payload=True)
    ids, blocks = stats["payload"]["w"]
    assert ids.shape == (2, 1) and blocks.shape == (2, 1, 8, 128)
    assert stats["sent_bytes"] == sum(i.numel() * 4 + b.numel() * 4
                                      for i, b in stats["payload"].values())


def test_compressed_grad_mean_leaves_inputs_untouched_and_keeps_structure():
    g = {"a": [t(mk((2, 5, 7), "float32", seed=20)),
               (t(mk((2, 3), "float32", seed=21)),)],
         "z": t(mk((2,), "float32", seed=22))}  # a 0-d leaf per pod
    g_before = [x.clone() for x in (g["a"][0], g["a"][1][0], g["z"])]
    r = gc.init_residuals(g)
    mean, new_r, _ = gc.compressed_grad_mean(g, r, ratio=0.5)
    assert isinstance(mean["a"], list) and isinstance(mean["a"][1], tuple)
    assert mean["a"][0].shape == (5, 7) and mean["z"].shape == ()
    assert new_r["a"][1][0].shape == (2, 3)
    for before, after in zip(g_before, (g["a"][0], g["a"][1][0], g["z"])):
        assert_same_bytes(after, before)
    assert all(float(x.abs().sum()) == 0 for x in
               (r["a"][0], r["a"][1][0], r["z"]))
    with pytest.raises(ValueError, match="structure"):
        gc.compressed_grad_mean(g, {"a": r["a"]})


def test_tree_leaf_order_matches_jax_flatten():
    tree = {"zeta": [1, (2, 3)], "alpha": {"b": 4, "a": 5}, "mid": 6}
    assert [leaf for _, leaf in gc._leaves(tree)] == jax.tree.leaves(tree)
    assert gc.tree_map(lambda v: v * 10, tree) == \
        jax.tree.map(lambda v: v * 10, tree)


def test_residuals_from_numpy_keeps_bytes():
    r = {"w": np.random.default_rng(5).standard_normal((2, 4, 6)).astype(np.float32)}
    got = gc.residuals_from_numpy(r, CPU)
    assert got["w"].dtype == torch.float32 and got["w"].device.type == "cpu"
    assert_same_bytes(got["w"], r["w"])


# ---------------------------------------------------------------------------
# launchers: no fallback
# ---------------------------------------------------------------------------

def test_new_launchers_refuse_cpu_tensors_and_count_nothing():
    before = (block_norms.launches, block_scatter.launches)
    x = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        block_norms.launch(x, (2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        block_scatter.launch(x, torch.zeros(1, dtype=torch.int32),
                             torch.zeros((1, 2, 2)))
    ops.block_topk(x, (2, 2), 1)
    ops.block_scatter(x, torch.zeros(1, dtype=torch.int32), torch.zeros((1, 2, 2)))
    assert (block_norms.launches, block_scatter.launches) == before
