"""The port's device read path (``repro_torch``) against the JAX package.

Every case of ``tests/test_device_read.py``'s device reads runs through the
port with ``device="cpu"``, where the kernels' plain PyTorch versions stand
in for the CUDA kernels. The port's bytes are held to ``repro``'s
``read_device`` output and to the host ``read`` / ``read_slice`` decode.
The two packages differ on purpose in a few places (the port holds f64, i64
and complex on the device, so there is no host fallback for them), so these
tests compare bytes, not ``info.path``, across packages.

Also here: tables carried across the two packages in both directions, the
import hygiene of ``repro_torch`` (no jax, no ``repro``, ml_dtypes
optional) and the rule that the default device (``"cuda"``) raises on a host
without a card instead of falling back to the CPU.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.lake as jlake
from repro_torch.core import DeltaTensorStore
from repro_torch.core.encodings.ftsf import FTSFCodec
from repro_torch.kernels import ops
from repro_torch.lake import (ChunkAssembler, InMemoryObjectStore,
                              LocalFSObjectStore, ReadExecutor, device,
                              set_unshuffle_kernel)
from repro_torch.lake.compression import get_unshuffle_kernel

from .test_encodings import sparse_tensor
from .test_torch_kernels import as_numpy, assert_same_bytes

CPU = "cpu"
# the reference's device-exact dtypes, plus what only the port holds exactly
DTYPES = ["float32", "float16", "int32", "int16", "uint8", "complex64", "bool",
          "float64", "int64", "bfloat16", "uint16"]


@pytest.fixture(autouse=True)
def _restore_unshuffle_hook():
    yield
    set_unshuffle_kernel(None)


@pytest.fixture
def cpu_unshuffle_hook():
    """The port's frame-decode hook on its plain version, for one test."""
    set_unshuffle_kernel(functools.partial(ops.unshuffle_host, device=CPU))
    yield


def port_store(io=None, compression=None):
    return DeltaTensorStore(InMemoryObjectStore(), "tensors",
                            io=io or ReadExecutor(max_workers=4),
                            compression=compression, device=CPU)


def ref_store(compression=None):
    return jcore.DeltaTensorStore(jlake.InMemoryObjectStore(), "tensors",
                                  io=jlake.ReadExecutor(max_workers=4),
                                  compression=compression)


def dense(shape, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape)
    if np.dtype(dtype).kind in "iub":
        return (x * 10).astype(dtype)
    return x.astype(dtype)


def both(x, **put):
    """The same tensor written into a port store and a reference store."""
    ps, rs = port_store(), ref_store()
    ps.put(x, tensor_id="x", **put)
    rs.put(x, tensor_id="x", **put)
    return ps, rs


# ---------------------------------------------------------------------------
# byte identity: port read_device vs repro read_device vs host decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_read_device_full_byte_identical(dtype):
    x = dense((6, 4, 8), dtype, seed=1)
    ps, rs = both(x, layout="ftsf", chunk_dims=2)
    with ps.open("x") as ref:
        out, info = ref.read_device(with_info=True, device=CPU)
        host = ref.read()
    with rs.open("x") as ref:
        want = np.asarray(ref.read_device())
    assert info.path == "block_gather" and info.on_device
    assert isinstance(out, torch.Tensor) and out.device.type == CPU
    assert_same_bytes(out, want)
    assert_same_bytes(out, host)
    assert_same_bytes(out, x)


def test_read_device_slice_byte_identical():
    x = dense((16, 3, 8, 8), "float32", seed=2)
    ps, rs = both(x, layout="ftsf", chunk_dims=3)
    spec = [(4, 11), None, None, None]
    with ps.open("x") as ref:
        out, info = ref.read_device(spec, with_info=True, device=CPU)
        host = ref.read_slice(spec)
    with rs.open("x") as ref:
        want, rinfo = ref.read_device(spec, with_info=True)
    assert info.path == "block_gather" and info.on_device
    assert_same_bytes(out, np.asarray(want))
    assert_same_bytes(out, host)
    # only the 7 wanted chunks were staged on the host, as in the reference
    assert info.host_staged_bytes == rinfo.host_staged_bytes == 7 * 3 * 8 * 8 * 4
    assert info.host_staged_bytes < x.nbytes


def test_read_device_subchunk_slice_crops_on_device():
    x = dense((8, 6, 10), "float32", seed=3)
    ps, rs = both(x, layout="ftsf", chunk_dims=2)
    spec = [(2, 5), (1, 4), (0, 7)]   # trailing dims narrow inside the chunk
    with ps.open("x") as ref:
        out, info = ref.read_device(spec, with_info=True, device=CPU)
        host = ref.read_slice(spec)
    with rs.open("x") as ref:
        want = np.asarray(ref.read_device(spec))
    assert info.on_device
    assert_same_bytes(out, want)
    assert_same_bytes(out, host)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int64", "bfloat16"])
def test_read_device_coo_scatter_byte_identical(dtype):
    x = sparse_tensor((64, 64), density=0.012, seed=4).astype(dtype)
    ps, rs = both(x, layout="coo")
    with ps.open("x") as ref:
        out, info = ref.read_device(with_info=True, device=CPU)
        host = ref.read()
    with rs.open("x") as ref:
        want = np.asarray(ref.read_device())
    assert info.path == "coo_scatter" and info.on_device
    assert_same_bytes(out, want)
    assert_same_bytes(out, host)
    # sparse staging beats densify-then-transfer on the host
    assert info.host_staged_bytes < x.nbytes
    assert info.device_bytes == x.nbytes


def test_read_device_coo_complex_values():
    x = np.zeros((16, 16), dtype=np.complex64)
    x[3, 4] = 1 + 2j
    x[9, 1] = -0.5j
    ps, rs = both(x, layout="coo")
    with ps.open("x") as ref:
        out, info = ref.read_device(with_info=True, device=CPU)
    with rs.open("x") as ref:
        want = np.asarray(ref.read_device())
    assert info.path == "coo_scatter" and info.on_device
    # -0.5j has a real part of -0.0: the port stores it (unique coordinates),
    # the reference adds it to +0.0, so the two agree in value, and only the
    # port agrees with the host read in bytes
    np.testing.assert_array_equal(as_numpy(out), want)
    assert_same_bytes(out, x)
    with ps.open("x") as ref:
        assert_same_bytes(out, ref.read())


def test_read_device_coo_slice():
    x = sparse_tensor((32, 48), density=0.05, seed=5).astype(np.float32)
    ps, rs = both(x, layout="coo")
    spec = [(8, 24), (0, 48)]
    with ps.open("x") as ref:
        out, info = ref.read_device(spec, with_info=True, device=CPU)
        host = ref.read_slice(spec)
    with rs.open("x") as ref:
        want = np.asarray(ref.read_device(spec))
    assert info.path == "coo_scatter"
    assert_same_bytes(out, want)
    assert_same_bytes(out, host)


@pytest.mark.parametrize("dtype", ["float64", "int64"])
def test_read_device_64bit_dtypes_stay_exact_on_device(dtype):
    # the reference keeps these in numpy without jax x64; torch holds them
    x = dense((4, 4, 6), dtype, seed=6)
    ps, rs = both(x, layout="ftsf", chunk_dims=2)
    with ps.open("x") as ref:
        out, info = ref.read_device(with_info=True, device=CPU)
    with rs.open("x") as ref:
        want = ref.read_device()
    assert info.path == "block_gather" and info.on_device
    assert out.dtype == getattr(torch, dtype)
    assert_same_bytes(out, np.asarray(want))
    assert_same_bytes(out, x)


@pytest.mark.parametrize("layout", ["csr", "csf", "bsgs"])
def test_read_device_other_layouts_take_host_decode(layout):
    x = sparse_tensor((24, 4, 16), density=0.05, seed=13).astype(np.float32)
    ps, rs = both(x, layout=layout)
    with ps.open("x") as ref:
        out, info = ref.read_device(with_info=True, device=CPU)
    with rs.open("x") as ref:
        want = np.asarray(ref.read_device())
    assert info.path == "host_fallback" and info.on_device
    assert info.host_staged_bytes == info.device_bytes == x.nbytes
    assert_same_bytes(out, want)
    assert_same_bytes(out, x)


def test_read_device_unsliceable_codec_raises(monkeypatch):
    store = port_store()
    store.put(dense((4, 8), "float32"), tensor_id="x", layout="ftsf")
    monkeypatch.setattr(FTSFCodec, "supports_slice", False)
    with store.open("x") as ref:
        with pytest.raises(NotImplementedError):
            ref.read_device([(0, 2), None], device=CPU)


def test_get_device_wrapper_and_bytes_to_device():
    store = port_store()
    x = dense((8, 16), "float32", seed=7)
    store.put(x, tensor_id="x", layout="ftsf")
    store.io.stats.reset()
    out = store.get_device("x")  # the store's own device: cpu
    assert_same_bytes(out, x)
    assert store.io_stats()["bytes_to_device"] == x.nbytes


# ---------------------------------------------------------------------------
# ChunkAssembler / scatter_coo / to_torch
# ---------------------------------------------------------------------------

def test_chunk_assembler_gathers_arrival_order():
    asm = ChunkAssembler(3, 4, np.float32, device=CPU)
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    for pos in (2, 0, 1):  # arrive out of order: slot 2 first
        asm.add(pos, rows[pos].tobytes())
    assert asm.staged_bytes == rows.nbytes
    assert_same_bytes(asm.gather(), rows)


def test_chunk_assembler_incomplete_raises():
    asm = ChunkAssembler(2, 4, np.float32, device=CPU)
    asm.add(0, np.zeros(4, np.float32).tobytes())
    with pytest.raises(ValueError):
        asm.gather()


def test_scatter_coo_empty_and_dense():
    out = device.scatter_coo(np.empty(0, np.int64), np.empty(0, np.float32), 8,
                             device=CPU)
    assert_same_bytes(out, np.zeros(8, np.float32))
    out = device.scatter_coo(np.array([1, 5]), np.array([2.0, 3.0], np.float32),
                             6, device=CPU)
    want = np.zeros(6, np.float32)
    want[[1, 5]] = [2.0, 3.0]
    assert_same_bytes(out, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "uint16", "uint32", "uint64",
                                   "bool", "complex128", "int8", "float16"])
def test_to_torch_keeps_bytes(dtype):
    x = dense((3, 5), dtype, seed=8)
    t = device.to_torch(x[:, 1:], CPU)  # non-contiguous input
    assert t.dtype == device.torch_dtype(np.dtype(dtype))
    assert_same_bytes(t, x[:, 1:])
    readonly = np.frombuffer(x.tobytes(), dtype=x.dtype).reshape(x.shape)
    assert_same_bytes(device.to_torch(readonly, CPU), x)


# ---------------------------------------------------------------------------
# batched device reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dev", [CPU, torch.device(CPU)])
def test_read_many_device_matches_host(dev):
    a = dense((8, 4, 4), "float32", seed=10)
    b = dense((6, 4, 4), "float32", seed=11)
    store, rs = port_store(), ref_store()
    for s in (store, rs):
        s.put(a, tensor_id="a", layout="ftsf", chunk_dims=2)
        s.put(b, tensor_id="b", layout="ftsf", chunk_dims=2)
    reqs = [("a", None), ("b", [(1, 5), None, None]), ("a", [(0, 3), None, None])]
    host = store.read_many(reqs)
    want = rs.read_many(reqs, device=True)
    store.io.stats.reset()
    dev_out = store.read_many(reqs, device=dev)
    for h, d, w in zip(host, dev_out, want):
        assert device.is_device_array(d, CPU)
        assert_same_bytes(d, h)
        assert_same_bytes(d, np.asarray(w))
    assert store.io_stats()["bytes_to_device"] == sum(h.nbytes for h in host)


# ---------------------------------------------------------------------------
# tables carried across the two packages
# ---------------------------------------------------------------------------

def _carry_tensors():
    x = dense((12, 3, 8, 8), "float32", seed=20)
    s = sparse_tensor((32, 48), density=0.05, seed=21).astype(np.float32)
    return x, s


def _write(store, x, s):
    store.put(x, tensor_id="dense", layout="ftsf", chunk_dims=3,
              target_file_bytes=2048)
    store.put(s, tensor_id="sparse", layout="coo")


def test_table_written_by_repro_reads_in_port(tmp_path, cpu_unshuffle_hook):
    x, s = _carry_tensors()
    _write(jcore.DeltaTensorStore(jlake.LocalFSObjectStore(str(tmp_path)), "t",
                                  compression="zlib+shuffle"), x, s)
    port = DeltaTensorStore(LocalFSObjectStore(str(tmp_path)), "t", device=CPU)
    assert port.compression.id == "zlib+shuffle"  # from the manifest
    for tid, want in (("dense", x), ("sparse", s)):
        assert_same_bytes(port.get(tid), want)
        assert_same_bytes(port.get_device(tid), want)
        assert_same_bytes(port.get_slice(tid, [(2, 5)]), want[2:5])
        assert_same_bytes(port.get_device(tid, [(2, 5)]), want[2:5])


def test_table_written_by_port_reads_in_repro(tmp_path):
    x, s = _carry_tensors()
    _write(DeltaTensorStore(LocalFSObjectStore(str(tmp_path)), "t",
                            compression="zlib+shuffle", device=CPU), x, s)
    ref = jcore.DeltaTensorStore(jlake.LocalFSObjectStore(str(tmp_path)), "t")
    assert ref.compression.id == "zlib+shuffle"
    for tid, want in (("dense", x), ("sparse", s)):
        assert_same_bytes(ref.get(tid), want)
        assert_same_bytes(np.asarray(ref.get_device(tid)), want)
        assert_same_bytes(ref.get_slice(tid, [(2, 5)]), want[2:5])


def test_both_packages_write_the_same_chunk_bytes(tmp_path):
    x, s = _carry_tensors()
    for sub, store in (("ref", jcore.DeltaTensorStore(
            jlake.LocalFSObjectStore(str(tmp_path / "ref")), "t",
            compression="zlib+shuffle")),
            ("port", DeltaTensorStore(LocalFSObjectStore(str(tmp_path / "port")),
                                      "t", compression="zlib+shuffle",
                                      device=CPU))):
        _write(store, x, s)
    blobs = {}
    for sub in ("ref", "port"):
        root = tmp_path / sub / "t"
        blobs[sub] = sorted((tmp_path / sub / p).read_bytes()
                            for p in _data_files(root, tmp_path / sub))
    assert blobs["ref"] and blobs["ref"] == blobs["port"]


def _data_files(root, base):
    # part files of the table, by content: names are uuids and differ
    return [os.path.relpath(os.path.join(d, f), base)
            for d, _, files in os.walk(root) for f in files
            if "_delta_log" not in d and "_cas" not in d]


# ---------------------------------------------------------------------------
# import hygiene, ml_dtypes optional, no fallback
# ---------------------------------------------------------------------------

def test_import_without_jax_repro_or_ml_dtypes(tmp_path):
    x = dense((5, 2, 3), "bfloat16", seed=30)
    store = DeltaTensorStore(LocalFSObjectStore(str(tmp_path)), "t", device=CPU)
    store.put(x, tensor_id="bf", layout="ftsf", chunk_dims=2)
    code = textwrap.dedent(f"""
        import json, sys
        sys.modules["ml_dtypes"] = None  # import ml_dtypes raises ImportError
        import repro_torch, repro_torch.core, repro_torch.lake
        import repro_torch.kernels, repro_torch.data.synthetic
        import repro_torch.core.device, repro_torch.train.grad_compress
        import repro_torch.data.stream, repro_torch.data.pipeline
        import repro_torch.data.ingest
        import repro_torch.models, repro_torch.serve, repro_torch.tree
        import repro_torch.examples.serve_lm
        import repro_torch.train, repro_torch.train.optimizer
        import repro_torch.train.trainer, repro_torch.train.checkpoint
        import repro_torch.launch.train, repro_torch.examples.train_lm
        import repro_torch.launch.serve, repro_torch.launch.ingest
        import repro_torch.launch.gc, repro_torch.configs.paper_store
        import repro_torch.examples.quickstart
        import repro_torch.examples.grad_compression
        import repro_torch.dist.sharding, repro_torch.launch.mesh
        import repro_torch.launch.specs, repro_torch.launch.dryrun
        import repro_torch.analysis.accounting, repro_torch.analysis.op_cost
        from repro_torch.core import DeltaTensorStore
        from repro_torch.lake import LocalFSObjectStore
        store = DeltaTensorStore(LocalFSObjectStore({str(tmp_path)!r}), "t",
                                 device="cpu")
        t = store.get_device("bf")
        host = store.get("bf")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(json.dumps({{"bad": bad, "dtype": str(t.dtype),
                          "host_dtype": str(host.dtype),
                          "bits": t.view(__import__("torch").int16)
                                   .reshape(-1).tolist()}}))
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    # bfloat16 reads without ml_dtypes: uint16 bits on the host, bf16 in torch
    assert got["dtype"] == "torch.bfloat16" and got["host_dtype"] == "uint16"
    assert got["bits"] == x.view(np.int16).reshape(-1).tolist()


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    store = DeltaTensorStore(InMemoryObjectStore(), "t")  # device="cuda"
    x = dense((4, 8), "float32")
    store.put(x, tensor_id="x", layout="ftsf")
    store.put(sparse_tensor((8, 8), density=0.1, seed=1).astype(np.float32),
              tensor_id="s", layout="coo")
    for call in (lambda: store.get_device("x"),
                 lambda: store.get_device("s"),
                 lambda: store.open("x").read_device(),
                 lambda: store.read_many([("x", None)], device=True),
                 lambda: store.catalog().read_many([("x", None)],
                                                   device="cuda")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert_same_bytes(store.get("x"), x)  # host reads are unaffected


def test_store_installs_the_cuda_unshuffle_hook_only_for_cuda():
    set_unshuffle_kernel(None)
    DeltaTensorStore(InMemoryObjectStore(), "t", device=CPU)
    assert get_unshuffle_kernel() is None
    DeltaTensorStore(InMemoryObjectStore(), "t")
    hook = get_unshuffle_kernel()
    assert hook.func is ops.unshuffle_host
    assert hook.keywords["device"] == torch.device("cuda")
    # the reference's own hook is untouched
    assert jlake.compression.get_unshuffle_kernel() is None


def test_host_numpy_views_match_ml_dtypes():
    assert as_numpy(torch.zeros(2, dtype=torch.bfloat16)).dtype == ml_dtypes.bfloat16
