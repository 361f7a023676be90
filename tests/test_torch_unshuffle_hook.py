"""The port's frame-decode hook, kernel variant choosers and launch path.

``ops.unshuffle_host`` writes the transposed items into the caller's
buffer (``out=``); the port's ``byte_unshuffle`` hands it the decoded
buffer itself, so frames written by the JAX package decode through the
port byte for byte with and without the hook. The variant choosers of
``unshuffle`` and ``block_gather`` are pure functions of shapes and
pointers, checked here for every case the kernels split on; the CUDA
variants themselves run only on the card (``chip_smoke.py``).
"""

import functools
import sys
import threading
import types
import warnings

import numpy as np
import pytest
import torch

from repro.lake import compression as jcomp
from repro_torch.kernels import _build, block_gather, ops, unshuffle
from repro_torch.lake import compression as tcomp

from .test_unshuffle_kernel import FIXED_WIDTH_DTYPES

RNG = np.random.default_rng(13)


@pytest.fixture(autouse=True)
def _restore_unshuffle_hook():
    yield
    tcomp.set_unshuffle_kernel(None)


def _planes(itemsize, n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (itemsize, n),
                                                dtype=np.uint8)


# ---------------------------------------------------------------------------
# unshuffle_host(..., out=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [1, 2, 3, 4, 8, 16, 32])
def test_unshuffle_host_writes_into_out(itemsize):
    planes = _planes(itemsize, 1000 + itemsize, seed=itemsize)
    buf = np.full((planes.shape[1], itemsize), 0xAB, dtype=np.uint8)
    got = ops.unshuffle_host(planes, device="cpu", out=buf)
    assert got is buf
    assert buf.tobytes() == np.ascontiguousarray(planes.T).tobytes()


def test_unshuffle_host_writes_into_a_view_of_a_larger_buffer():
    # byte_unshuffle's call: out[:n] of the decoded buffer, reshaped
    planes = _planes(4, 257, seed=3)
    whole = np.zeros(4 * 257 + 3, dtype=np.uint8)
    ops.unshuffle_host(planes, device="cpu", out=whole[:4 * 257].reshape(-1, 4))
    assert whole[:4 * 257].tobytes() == np.ascontiguousarray(planes.T).tobytes()
    assert not whole[4 * 257:].any()


def test_unshuffle_host_rejects_an_out_of_the_wrong_shape_or_dtype():
    planes = _planes(4, 64)
    with pytest.raises(ValueError, match="out"):
        ops.unshuffle_host(planes, device="cpu", out=np.empty((4, 64), np.uint8))
    with pytest.raises(ValueError, match="out"):
        ops.unshuffle_host(planes, device="cpu", out=np.empty((64, 4), np.int8))


def test_unshuffle_host_with_out_from_many_threads():
    # decode-pool threads call the hook at once, each with its own out
    planes = [_planes(4, 4096 + 16 * i, seed=i) for i in range(16)]
    ok = [True] * len(planes)

    def work(i):
        for _ in range(20):
            buf = np.empty((planes[i].shape[1], 4), dtype=np.uint8)
            ops.unshuffle_host(planes[i], device="cpu", out=buf)
            ok[i] &= np.array_equal(buf, planes[i].T)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(planes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert all(ok)


def test_byte_unshuffle_hands_the_hook_its_output_buffer():
    seen = []

    def hook(planes, *, out):
        seen.append(out)
        return ops.unshuffle_host(planes, device="cpu", out=out)

    raw = RNG.integers(0, 256, 4 * 300 + 2, dtype=np.uint8).tobytes()
    tcomp.set_unshuffle_kernel(hook)
    got = tcomp.byte_unshuffle(bytes(tcomp.byte_shuffle(raw, 4)), 4)
    assert bytes(got) == raw
    assert len(seen) == 1 and seen[0].shape == (300, 4)
    # the hook's out is a view of the returned buffer: no copy after it
    assert np.shares_memory(seen[0], np.frombuffer(got, dtype=np.uint8))


# ---------------------------------------------------------------------------
# frames of the JAX package through the port's decode_frame
# ---------------------------------------------------------------------------

def _compressible_bytes(dtype, nbytes):
    dt = np.dtype(dtype)
    count = nbytes // dt.itemsize + 1
    vals = (np.arange(count) % 5).astype(dt) if dt != np.bool_ else \
        (np.arange(count) % 3 == 0)
    return vals.tobytes()[:nbytes]


@pytest.mark.parametrize("hooked", [True, False], ids=["cpu-hook", "no-hook"])
@pytest.mark.parametrize("dtype", FIXED_WIDTH_DTYPES)
def test_reference_frames_decode_byte_identically_in_the_port(dtype, hooked):
    it = np.dtype(dtype).itemsize
    calls = []

    def hook(planes, *, out):
        calls.append(planes.shape)
        return ops.unshuffle_host(planes, device="cpu", out=out)

    tcomp.set_unshuffle_kernel(hook if hooked else None)
    spec = jcomp.parse_compression("zlib+shuffle")
    for n in (0, 1, it, 7 * it + 3, 4096):
        raw = _compressible_bytes(dtype, n)
        frame, codec = jcomp.encode_frame(raw, spec, itemsize=it)
        if n == 4096:
            assert jcomp.is_framed(frame), codec
            assert jcomp.frame_info(frame)["shuffle"] == (it > 1)
        assert bytes(tcomp.decode_frame(frame)) == raw
        assert bytes(jcomp.decode_frame(frame)) == raw
    if hooked and it > 1:
        assert (it, 4096 // it) in calls  # the hook did the 4096-byte frame
    if not hooked or it == 1:
        assert not calls


# ---------------------------------------------------------------------------
# variant choosers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize,n,planes_ptr,out_ptr,want", [
    (4, 3 * 2 ** 20, 0x7F0000000000, 0x7F1000000000, "register"),  # main path
    (4, 3146018, 0x7F0000000000, 0x7F1000000000, "register"),  # a chunk's frame
    (2, 16, 256, 512, "register"),
    (8, 4096, 4096, 8192, "register"),
    (16, 32, 16, 48, "register"),
    (4, 3 * 2 ** 20, 0x7F0000000001, 0x7F1000000000, "register"),  # planes + 1
    (4, 4096, 4104, 8192, "register"),   # 8-byte aligned planes
    (4, 4093, 4096, 8192, "register"),   # ragged n
    (4, 17, 4096, 8192, "register"),
    (2, 15, 4096, 8192, "register"),
    (8, 1, 4097, 8192, "register"),      # the tail alone
    (4, 4096, 4096, 8196, "shared"),     # misaligned out
    (16, 4096, 4096, 8200, "shared"),
    (1, 4096, 4096, 8192, "shared"),     # itemsizes without a register form
    (3, 4096, 4096, 8192, "shared"),
    (32, 4096, 4096, 8192, "shared"),
])
def test_unshuffle_variant(itemsize, n, planes_ptr, out_ptr, want):
    # n and the planes' alignment play no part: the register variant copies
    # a ragged tail and reads misaligned plane rows itself
    assert unshuffle.variant(itemsize, out_ptr) == want


@pytest.mark.parametrize("itemsize", [0, 33, 64])
def test_unshuffle_variant_refuses_itemsizes_out_of_range(itemsize):
    with pytest.raises(ValueError, match="itemsize"):
        unshuffle.variant(itemsize, 8192)


ROW = 3 * 1024 * 1024  # elements of one FTSF image row


@pytest.mark.parametrize("n,bh,bw,itemsize,x_ptr,out_ptr,want", [
    (ROW, 1, ROW, 4, 0x7F0000000000, 0x7F1000000000, "rows_tma"),  # FTSF read
    (1000, 1, 1000, 4, 256, 512, "rows_tma"),   # 4000-byte rows
    (8000, 1, 1000, 2, 256, 512, "rows_tma"),   # several tiles per row
    (128, 1, 128, 8, 16, 32, "rows_tma"),
    (12800, 8, 128, 4, 256, 512, "tiles"),      # the compressor's (8, 128)
    (333, 1, 333, 4, 256, 512, "tiles"),        # 1332-byte rows
    (1000, 1, 1000, 1, 256, 512, "tiles"),      # 1000-byte rows
    (130, 1, 64, 4, 256, 512, "tiles"),         # ragged edge
    (ROW, 1, ROW, 4, 0x7F0000000004, 0x7F1000000000, "tiles"),  # x 4 B off
    (ROW, 1, ROW, 4, 0x7F0000000000, 0x7F1000000008, "tiles"),  # out 8 B off
])
def test_block_gather_variant(n, bh, bw, itemsize, x_ptr, out_ptr, want):
    assert block_gather.variant(n, bh, bw, itemsize, x_ptr, out_ptr) == want


def test_block_gather_variant_is_the_same_for_every_id():
    # ids out of range (zero tiles) and negative (tile 0) are the kernel's
    # business in both variants: the chooser never sees them
    import inspect
    assert "ids" not in inspect.signature(block_gather.variant).parameters
    x = torch.arange(4 * 64, dtype=torch.float32).reshape(4, 64)
    ids = torch.tensor([7, -1, 0, 3, 4], dtype=torch.int32)  # 4 tiles
    got = ops.block_gather(x, ids, (1, 64))
    assert torch.equal(got[0], torch.zeros(1, 64))
    assert torch.equal(got[1], x[:1]) and torch.equal(got[2], x[:1])
    assert torch.equal(got[3], x[3:4]) and torch.equal(got[4], torch.zeros(1, 64))


# ---------------------------------------------------------------------------
# the launch path
# ---------------------------------------------------------------------------

def test_build_function_is_memoised_and_loads_once(monkeypatch):
    loads = []
    fake = types.SimpleNamespace(rt_fake=types.SimpleNamespace())

    def load(name):
        loads.append(name)
        return fake

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_FUNCS", {})
    first = _build.function("fake", "rt_fake", ["a"])
    second = _build.function("fake", "rt_fake", ["a"])
    assert first is second is fake.rt_fake
    assert loads == ["fake"]
    assert first.argtypes == ["a"]
    assert first.restype is _build.ctypes.c_int


def test_device_scope_is_a_no_op_off_the_card():
    scope = _build.device_scope(torch.zeros(1))
    with scope:
        pass
    assert not isinstance(scope, torch.cuda.device)


def test_cuda_hook_with_out_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    tcomp.set_unshuffle_kernel(functools.partial(ops.unshuffle_host,
                                                 device="cuda"))
    with pytest.raises(RuntimeError):
        tcomp.byte_unshuffle(bytes(tcomp.byte_shuffle(bytes(range(64)), 4)), 4)


@pytest.mark.parametrize("rows", [
    torch.empty((4, 64), dtype=torch.uint8),             # on the CPU
    torch.empty((4, 80), dtype=torch.uint8)[:, :64],     # not contiguous
    torch.empty((4, 64), dtype=torch.int8),
    torch.empty((64, 4), dtype=torch.uint8),
])
def test_upload_planes_wants_contiguous_cuda_rows_of_the_planes_shape(rows):
    with pytest.raises(ValueError, match="CUDA"):
        unshuffle.upload_planes(_planes(4, 64), rows)


def test_unshuffle_host_reads_read_only_planes_without_a_warning():
    raw = _planes(4, 100, seed=7).tobytes()
    planes = np.frombuffer(raw, dtype=np.uint8).reshape(4, 100)  # as decoded
    assert not planes.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = ops.unshuffle_host(planes, device="cpu")
    assert got.tobytes() == np.ascontiguousarray(planes.T).tobytes()


def test_unshuffle_host_rejects_a_read_only_out():
    planes = _planes(4, 64)
    out = np.frombuffer(bytes(256), dtype=np.uint8).reshape(64, 4)
    with pytest.raises(ValueError, match="writable"):
        ops.unshuffle_host(planes, device="cpu", out=out)
