"""The port's kernels (``repro_torch.kernels``) against the JAX package.

On this CPU host every entry point takes its kernel's plain PyTorch version,
because the operands lie on the CPU. Each plain version is held to the JAX
oracle (``repro.kernels.ref``) and to the Pallas kernel run in interpret
mode (``repro.kernels.ops.*(use_pallas=True)``, as ``tests/test_kernels.py``
runs it), on the same numpy inputs. Data movement matches bit for bit; the
one tolerance is the scatter-add of duplicate float indices (see
``DUP_RTOL``). The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds them to these plain versions.
"""

import functools
import sys
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import (_build, adamw, block_gather, coo_scatter,
                                 ops, unshuffle)
from repro_torch.lake import (byte_shuffle, byte_unshuffle,
                              set_unshuffle_kernel)
from repro_torch.lake.device import to_torch

from .test_kernels import SHAPES_BLOCKS
from .test_unshuffle_kernel import FIXED_WIDTH_DTYPES

RNG = np.random.default_rng(41)

# Scatter-add of duplicate float indices: the JAX oracle and torch's
# index_put_ may add a duplicate's values in different orders, so sums may
# differ in the last bits; every other comparison here is exact.
DUP_RTOL = 1e-6

_VIEWS = {torch.bfloat16: (torch.int16, ml_dtypes.bfloat16),
          torch.uint16: (torch.int16, np.uint16),
          torch.uint32: (torch.int32, np.uint32),
          torch.uint64: (torch.int64, np.uint64)}


@pytest.fixture(autouse=True)
def _restore_unshuffle_hook():
    yield
    set_unshuffle_kernel(None)


def as_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's contents as numpy, with the dtype the store writes."""
    t = t.detach().cpu().contiguous()
    if t.dtype in _VIEWS:
        signed, np_dtype = _VIEWS[t.dtype]
        return t.view(signed).numpy().view(np_dtype)
    return t.numpy()


def assert_same_bytes(got, want) -> None:
    """Equal dtype, shape and bytes (``got``/``want``: tensor or array)."""
    got = as_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    want = as_numpy(want) if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.ascontiguousarray(got).tobytes() == \
        np.ascontiguousarray(want).tobytes()


def mk(shape, dtype, seed=0) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(shape)
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return x > 0
    if dtype.kind in "iu":
        return (np.abs(x) * 50 if dtype.kind == "u" else x * 50).astype(dtype)
    if dtype.kind == "c":
        return (x + 1j * x[::-1]).astype(dtype)
    return x.astype(dtype)


def _ids(n_blocks, k):
    # includes the padding id n_blocks, which yields a zero tile
    return RNG.choice(n_blocks + 1, size=k, replace=False).astype(np.int32)


# ---------------------------------------------------------------------------
# block_gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,bs", SHAPES_BLOCKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_block_gather_plain_matches_ref_and_pallas(shape, bs, dtype):
    x = mk(shape, dtype, seed=1)
    gh, gw = -(-shape[0] // bs[0]), -(-shape[1] // bs[1])
    ids = _ids(gh * gw, min(gh * gw, 5))
    got = ops.block_gather(to_torch(x, "cpu"), torch.from_numpy(ids), bs)
    want_ref = jops.block_gather(jnp.asarray(x), jnp.asarray(ids), bs,
                                 use_pallas=False)
    want_pallas = jops.block_gather(jnp.asarray(x), jnp.asarray(ids), bs,
                                    use_pallas=True)
    assert_same_bytes(got, np.asarray(want_ref))
    assert_same_bytes(got, np.asarray(want_pallas))


def test_block_gather_row_tiles_permute_rows():
    # the FTSF read's shape: one (1, row_elems) tile per staged chunk row
    x = mk((64, 3 * 16 * 16), "float32", seed=2)
    ids = RNG.permutation(64).astype(np.int32)
    got = ops.block_gather(to_torch(x, "cpu"), torch.from_numpy(ids),
                           (1, x.shape[1]))
    assert_same_bytes(got, x[ids][:, None, :])
    want = jops.block_gather(jnp.asarray(x), jnp.asarray(ids), (1, x.shape[1]),
                             use_pallas=True)
    assert_same_bytes(got, np.asarray(want))


@pytest.mark.parametrize("dtype", ["float16", "int8", "uint8", "bool",
                                   "complex64", "uint16"])
def test_block_gather_plain_other_dtypes_match_ref(dtype):
    x = mk((9, 130), dtype, seed=3)
    ids = _ids(3 * 3, 6)
    got = ops.block_gather(to_torch(x, "cpu"), torch.from_numpy(ids), (4, 64))
    want = np.asarray(jref.block_gather(jnp.pad(jnp.asarray(x), ((0, 3), (0, 62))),
                                        jnp.asarray(ids), (4, 64)))
    # the oracle's zero fill promotes bool tiles to int32; values agree
    assert_same_bytes(got, want.astype(x.dtype))


def test_block_gather_negative_id_reads_tile_zero_like_ref():
    x = mk((8, 8), "float32", seed=4)
    ids = np.array([-1, 3, 4], np.int32)
    got = ops.block_gather(to_torch(x, "cpu"), torch.from_numpy(ids), (4, 4))
    assert_same_bytes(got, np.asarray(jref.block_gather(jnp.asarray(x),
                                                        jnp.asarray(ids), (4, 4))))


# ---------------------------------------------------------------------------
# unshuffle
# ---------------------------------------------------------------------------

def _planes(itemsize, n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (itemsize, n),
                                                dtype=np.uint8)


@pytest.mark.parametrize("dtype", FIXED_WIDTH_DTYPES)
def test_unshuffle_plain_matches_pallas_every_fixed_width_dtype(dtype):
    it = np.dtype(dtype).itemsize
    planes = _planes(it, 1024, seed=it)
    got = ops.unshuffle(torch.from_numpy(planes))
    assert_same_bytes(got, np.asarray(jops.unshuffle(jnp.asarray(planes),
                                                     use_pallas=True)))
    assert_same_bytes(got, planes.T)


@pytest.mark.parametrize("n", [1, 3, 511, 512, 513, 1300])
def test_unshuffle_plain_ragged_widths(n):
    planes = _planes(4, n, seed=n)
    got = ops.unshuffle(torch.from_numpy(planes))
    assert_same_bytes(got, np.asarray(jref.unshuffle(jnp.asarray(planes))))
    assert_same_bytes(got, np.asarray(jops.unshuffle(jnp.asarray(planes),
                                                     use_pallas=True)))


@pytest.mark.parametrize("dtype", FIXED_WIDTH_DTYPES)
def test_unshuffle_hook_byte_identical_to_numpy(dtype):
    it = np.dtype(dtype).itemsize
    for n in (0, 1, it, 7 * it + 3, 4096):
        raw = RNG.integers(0, 256, n, dtype=np.uint8).tobytes()
        shuf = bytes(byte_shuffle(raw, it))
        set_unshuffle_kernel(None)
        want = bytes(byte_unshuffle(shuf, it))
        set_unshuffle_kernel(functools.partial(ops.unshuffle_host, device="cpu"))
        got = bytes(byte_unshuffle(shuf, it))
        assert got == want == raw


def test_unshuffle_hook_from_many_threads():
    # the hook runs on ReadExecutor's decode-pool threads, all at once
    set_unshuffle_kernel(functools.partial(ops.unshuffle_host, device="cpu"))
    raws = [RNG.integers(0, 256, 4096 + 3 * i, dtype=np.uint8).tobytes()
            for i in range(16)]
    shuffled = [bytes(byte_shuffle(r, 4)) for r in raws]
    results = [[] for _ in raws]

    def work(i):
        for _ in range(20):
            results[i].append(bytes(byte_unshuffle(shuffled[i], 4)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert all(res == [raw] * 20 for res, raw in zip(results, raws))


def test_unshuffle_host_returns_numpy_from_readonly_planes():
    planes = np.frombuffer(_planes(8, 640, seed=2).tobytes(),
                           dtype=np.uint8).reshape(8, 640)  # read-only
    out = ops.unshuffle_host(planes, device="cpu")
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, planes.T)


# ---------------------------------------------------------------------------
# coo_scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,k", [(512, 17), (1024, 100), (640, 1), (130, 9)])
def test_coo_scatter_plain_matches_ref_and_pallas(size, k):
    idx = RNG.choice(size, size=k, replace=False).astype(np.int32)
    vals = mk((k,), "float32", seed=5)
    for unique in (True, False):
        got = ops.coo_scatter(torch.from_numpy(idx), to_torch(vals, "cpu"), size,
                              unique=unique)
        assert_same_bytes(got, np.asarray(jref.coo_scatter(
            jnp.asarray(idx), jnp.asarray(vals), size)))
        assert_same_bytes(got, np.asarray(jops.coo_scatter(
            jnp.asarray(idx), jnp.asarray(vals), size, use_pallas=True)))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "int32", "int8",
                                   "uint8", "int16", "complex64"])
def test_coo_scatter_plain_dtypes_match_ref(dtype):
    size, k = 300, 40
    idx = RNG.choice(size, size=k, replace=False).astype(np.int64)
    vals = mk((k,), dtype, seed=6)
    want = np.asarray(jref.coo_scatter(jnp.asarray(idx), jnp.asarray(vals), size))
    for unique in (True, False):
        got = ops.coo_scatter(torch.from_numpy(idx), to_torch(vals, "cpu"), size,
                              unique=unique)
        assert_same_bytes(got, want)


@pytest.mark.parametrize("dtype", ["float32", "int32", "int8", "uint16"])
def test_coo_scatter_duplicates_add(dtype):
    size, k = 64, 200
    idx = RNG.integers(0, size, k).astype(np.int64)
    vals = mk((k,), dtype, seed=7)
    got = as_numpy(ops.coo_scatter(torch.from_numpy(idx), to_torch(vals, "cpu"),
                                   size))
    if dtype == "uint16":  # jax has no uint16 add on this path: numpy oracle
        want = np.zeros(size, np.uint16)
        np.add.at(want, idx, vals)
    else:
        want = np.asarray(jref.coo_scatter(jnp.asarray(idx), jnp.asarray(vals),
                                           size))
    assert got.dtype == want.dtype
    if np.dtype(dtype).kind == "f":
        np.testing.assert_allclose(got, want, rtol=DUP_RTOL)
    else:
        np.testing.assert_array_equal(got, want)


def test_coo_scatter_bool_duplicates_or():
    idx = np.array([1, 1, 2, 5, 5], np.int64)
    vals = np.array([True, True, False, False, True])
    got = ops.coo_scatter(torch.from_numpy(idx), torch.from_numpy(vals), 6)
    assert_same_bytes(got, np.array([0, 1, 0, 0, 0, 1], bool))


def test_coo_scatter_padding_drops_and_negative_wraps():
    idx = np.array([5, 700, 1000, -1, -600], np.int32)  # 700/1000/-600 drop
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    got = ops.coo_scatter(torch.from_numpy(idx), to_torch(vals, "cpu"), 512)
    assert_same_bytes(got, np.asarray(jref.coo_scatter(jnp.asarray(idx),
                                                       jnp.asarray(vals), 512)))
    assert float(got[5]) == 1.0 and float(got[511]) == 4.0
    assert float(got.sum()) == 5.0
    pallas = jops.coo_scatter(jnp.asarray(idx[:3]), jnp.asarray(vals[:3]), 512,
                              use_pallas=True)
    assert_same_bytes(got[:511], np.asarray(pallas)[:511])


def test_coo_scatter_empty_pairs_give_zeros():
    got = ops.coo_scatter(torch.zeros(0, dtype=torch.int64),
                          torch.zeros(0, dtype=torch.float64), 7)
    assert_same_bytes(got, np.zeros(7, np.float64))


# ---------------------------------------------------------------------------
# dispatch and build: no fallback
# ---------------------------------------------------------------------------

def test_kernel_launchers_refuse_cpu_tensors_and_count_nothing():
    before = (block_gather.launches, unshuffle.launches, coo_scatter.launches)
    x = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        block_gather.launch(x, torch.zeros(1, dtype=torch.int32), (2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        unshuffle.launch(torch.zeros((4, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        coo_scatter.launch(torch.zeros(1, dtype=torch.int64), torch.ones(1), 4)
    # the CPU route never counts a launch
    ops.block_gather(x, torch.zeros(1, dtype=torch.int32), (2, 2))
    assert (block_gather.launches, unshuffle.launches,
            coo_scatter.launches) == before


def _adamw_operands(case):
    """(g, p, m, v, scalars) of a (2, 3, 8) leaf, spoiled as ``case`` says."""
    shape = (2, 3, 8)
    g = torch.zeros(shape, dtype=torch.bfloat16)
    p = torch.zeros(shape, dtype=torch.bfloat16)
    m, v = torch.zeros(shape), torch.zeros(shape)
    scalars = [torch.tensor(1.0) for _ in range(4)]
    if case == "broadcast_g":       # a layout the kernel takes
        g = torch.zeros((3, 8))[None].expand(shape)
    elif case == "g_not_broadcast":
        g = torch.zeros((3, 8))
    elif case == "g_transposed":
        g = torch.zeros((2, 8, 3), dtype=torch.bfloat16).transpose(1, 2)
    elif case == "m_not_contiguous":
        m = torch.zeros((2, 8, 3)).transpose(1, 2)
    elif case == "v_not_contiguous":
        v = torch.zeros((3, 2, 8)).transpose(0, 1)
    elif case == "p_not_contiguous":
        p = torch.zeros((2, 8, 3), dtype=torch.bfloat16).transpose(1, 2)
    elif case == "p_float64":
        p = p.double()
    elif case == "g_int32":
        g = g.int()
    elif case == "m_bfloat16":
        m = m.bfloat16()
    elif case == "scale_float64":
        scalars[0] = scalars[0].double()
    return g, p, m, v, scalars


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA"),
    ("broadcast_g", ValueError, "CUDA"),
    ("g_not_broadcast", ValueError, "shaped like p"),
    ("g_transposed", ValueError, "contiguous g"),
    ("m_not_contiguous", ValueError, "contiguous m"),
    ("v_not_contiguous", ValueError, "contiguous v"),
    ("p_not_contiguous", ValueError, "contiguous p"),
    ("p_float64", TypeError, "float64 path for p"),
    ("g_int32", TypeError, "int32 path for g"),
    ("m_bfloat16", TypeError, "f32 m"),
    ("scale_float64", TypeError, "f32 step scalars"),
])
def test_adamw_launch_refuses_and_counts_nothing(case, error, match):
    """``adamw.launch`` refuses CPU tensors (a broadcast g, which it takes
    on the card, included), a g that is not p's shape or lies otherwise
    than contiguous or broadcast over leading dims, non-contiguous m, v or
    p, and dtypes outside its set; nothing is counted."""
    g, p, m, v, scalars = _adamw_operands(case)
    before = adamw.launches
    with pytest.raises(error, match=match):
        adamw.launch(g, p, m, v, *scalars, b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=0.1)
    assert adamw.launches == before


def test_dispatch_refuses_other_devices():
    with pytest.raises(ValueError, match="device"):
        ops.unshuffle(torch.zeros((2, 4), dtype=torch.uint8, device="meta"))


def test_cuda_hook_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    set_unshuffle_kernel(functools.partial(ops.unshuffle_host, device="cuda"))
    with pytest.raises(RuntimeError):
        byte_unshuffle(bytes(byte_shuffle(bytes(range(64)), 4)), 4)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_build_library_name_tracks_source_and_flags():
    assert "adamw" in _build.SOURCES
    paths = {name: _build.lib_path(name) for name in _build.SOURCES}
    assert len(set(paths.values())) == len(_build.SOURCES)
    for name, path in paths.items():
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert (_build.CSRC / f"{name}.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS
