"""The kernel probes as modules found by name (``yardstick/probes/``): the
moved byte counts against counts by hand, ``adamw``'s least bytes, a probe
added as one new file and wrapped only where a metric reads it, and the
roofline share they feed."""

import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from conftest import BENCH, ROOT


def _probes():
    from yardstick import probes
    return probes.read_by(f"{k}_roofline" for k in probes.names())


def test_every_probe_names_its_target():
    import importlib
    found = _probes()
    assert {"adamw", "block_gather", "block_norms", "block_scatter"} <= set(found)
    for name, probe in found.items():
        assert probe.MODULE.split(".")[0] == "repro_torch", name
        assert callable(getattr(importlib.import_module(probe.MODULE), probe.ATTR))


@pytest.mark.parametrize("kernel,args,kw,want", [
    # the launches of test_kernel_bytes_by_hand: a (10, 300) f32 operand in
    # (8, 128) tiles, a 2 x 3 grid ragged on both edges, tile 5 holding 2 x 44
    ("block_norms", (torch.zeros(10, 300), (8, 128)), {}, 10 * 300 * 4 + 6 * 4),
    ("block_norms", (torch.zeros(8, 128, dtype=torch.bfloat16), (8, 128)), {},
     8 * 128 * 2 + 4),
    ("block_gather", (torch.zeros(10, 300), torch.tensor([0, 5]), (8, 128)), {},
     2 * 4 + (8 * 128 + 2 * 44) * 4 + 2 * 8 * 128 * 4),
    ("block_scatter", (torch.zeros(10, 300), torch.tensor([0, 5]),
                       torch.zeros(2, 8, 128)), {"inplace": True},
     2 * 4 + 2 * 8 * 128 * 4 + (8 * 128 + 2 * 44) * 4),
    ("block_scatter", (torch.zeros(10, 300), torch.tensor([5]),
                       torch.zeros(1, 8, 128)), {},
     4 + 8 * 128 * 4 + 88 * 4 + 2 * 10 * 300 * 4),
])
def test_moved_probes_count_as_by_hand(kernel, args, kw, want):
    probe = _probes()[kernel]
    noted = probe.note(args, kw, None)
    assert probe.least_bytes(noted) == want
    assert probe.flops(noted) == 0


@pytest.mark.parametrize("g_dtype,per_element", [(torch.bfloat16, 22), (torch.float32, 24)])
def test_adamw_least_bytes_by_hand(g_dtype, per_element):
    probe = _probes()["adamw"]
    n = 10 * 4096 * 12800

    def noted(g, p):
        m = torch.empty(p.shape, dtype=torch.float32, device="meta")
        scalars = (torch.zeros(()),) * 4
        return probe.note((g, p, m, m) + scalars, {}, None)
    p = torch.empty((10, 4096, 12800), dtype=torch.bfloat16, device="meta")
    g = torch.empty(p.shape, dtype=g_dtype, device="meta")
    assert probe.least_bytes(noted(g, p)) == per_element * n
    if g_dtype == torch.bfloat16:
        assert probe.least_bytes(noted(g, p)) == 11_534_336_000
    # the compressed step's mean broadcast over the pod axis (stride 0) is
    # read once; the podded param, moments and update are whole
    inner = torch.empty((3, 5), dtype=g_dtype)
    pod = torch.empty((2, 3, 5), dtype=torch.bfloat16)
    bcast = inner.expand(2, 3, 5)
    assert bcast.stride()[0] == 0
    want = 15 * g_dtype.itemsize + 2 * 30 * (2 + 4 + 4)
    assert probe.least_bytes(noted(bcast, pod)) == want
    assert probe.flops(noted(bcast, pod)) == 0


def test_probes_wrap_and_count_the_kernels():
    """Wrapping the targets: a launch is noted and summed per kernel, and
    the program's attribute is restored after."""
    import repro_torch.kernels.adamw as aw
    import repro_torch.kernels.block_norms as bn
    from yardstick import program
    probes = program.Probes(["block_norms_roofline", "compress_ms", "missing_roofline"])
    assert set(probes.kernels) == {"block_norms"}
    orig, other = bn.launch, aw.launch
    with probes.active():
        assert bn.launch is not orig
        assert aw.launch is other
    assert bn.launch is orig
    probes.launches["block_norms"].append(
        _probes()["block_norms"].note((torch.zeros(10, 300), (8, 128)), {}, None))
    assert probes.kernel_bytes() == {"block_norms": 10 * 300 * 4 + 6 * 4}
    assert probes.kernel_flops() == {"block_norms": 0}


def test_a_probe_is_one_new_file(tmp_path):
    """A probe module written into a copy of the benchmark is loaded and
    its target wrapped in a ``bench.kernel.<name>`` range where its metric
    is read, with no other file changed, and left unwrapped where it is
    not: here the CPU path of ``coo_scatter``, which the program's entry
    point looks up at each call."""
    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "yardstick" / "probes" / "coo_scatter.py").write_text(
        'MODULE, ATTR = "repro_torch.kernels.coo_scatter", "plain"\n\n\n'
        "def note(args, kw, out):\n    return args[1].numel(), out.numel()\n\n\n"
        "def least_bytes(noted):\n    return 4 * sum(noted)\n\n\n"
        "def flops(noted):\n    return noted[0]\n")
    code = f"""
import sys, torch
sys.path[:0] = [{str(bench)!r}, {str(ROOT / "src")!r}]
from torch.profiler import profile, ProfilerActivity
from yardstick import program
from repro_torch.kernels import ops
others = program.Probes(["adamw_roofline", "block_norms_roofline"])
with others.active(), profile(activities=[ProfilerActivity.CPU]) as prof:
    ops.coo_scatter(torch.tensor([1, 4]), torch.ones(2), 6)
assert not [e.key for e in prof.key_averages() if e.key == "bench.kernel.coo_scatter"]
assert "coo_scatter" not in others.kernels
probes = program.Probes(["coo_scatter_roofline"])
with probes.active(), profile(activities=[ProfilerActivity.CPU]) as prof:
    ops.coo_scatter(torch.tensor([1, 4]), torch.ones(2), 6)
assert [e.key for e in prof.key_averages() if e.key == "bench.kernel.coo_scatter"]
print(probes.kernel_bytes()["coo_scatter"], probes.kernel_flops()["coo_scatter"])
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == [str(4 * (2 + 6)), "2"]


class _Trace:
    def __init__(self, seconds):
        self.seconds = seconds

    def device_seconds(self, label):
        return self.seconds.get(label)


def test_roofline_share():
    from yardstick import peaks, roofline
    run = SimpleNamespace(trace=_Trace({"bench.kernel.k": 2e-3}),
                          kernel_bytes={"k": 3.35e9}, kernel_flops={"k": 0})
    assert roofline.share(run, "k") == pytest.approx(50.0)
    # the larger of the two bounds: operations at the bf16 peak
    run.kernel_flops = {"k": peaks.BF16_FLOPS * 1.5e-3}
    assert roofline.share(run, "k") == pytest.approx(75.0)
    assert roofline.share(run, "other") is None
    run.trace = _Trace({})
    assert roofline.share(run, "k") is None
    run.trace = None
    assert roofline.share(run, "k") is None


@pytest.mark.parametrize("kernel", ["block_norms", "block_gather", "block_scatter"])
def test_compressor_roofline_readers_read_the_share(kernel):
    """The compressor's three readers give what they computed by hand
    before they called ``roofline.share``, to rounding."""
    from yardstick import peaks, spec
    seconds, least = 1.7e-3, 4_711_000_123
    run = SimpleNamespace(trace=_Trace({f"bench.kernel.{kernel}": seconds}),
                          kernel_bytes={kernel: least}, kernel_flops={kernel: 0})
    got = spec.reader(ROOT, f"{kernel}_roofline")(run)
    assert got == pytest.approx(100.0 * least / peaks.HBM_BYTES_PER_S / seconds, rel=1e-15)
    run.kernel_bytes = {}
    assert spec.reader(ROOT, f"{kernel}_roofline")(run) is None


@pytest.mark.parametrize("cell,want", [
    ("granite-3-8b.bsgs_sft", {"adamw", "block_gather", "block_norms", "block_scatter"}),
    ("granite-3-8b.plain_sft", {"adamw"}),
])
def test_a_cell_probes_only_the_kernels_its_metrics_read(cell, want):
    from yardstick import program, spec
    c = spec.load(ROOT, cell)
    assert set(program.Probes(m["name"] for m in c.per_layer).kernels) == want
