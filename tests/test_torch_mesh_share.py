"""A rank of a mesh does the reference's share of a train step's FLOPs.

The reference's count: ``tools/reference_rank_flops.py`` in a subprocess
(it sets ``XLA_FLAGS`` for 16 host devices before jax starts, builds each
mesh with ``jax.make_mesh(..., axis_types=(AxisType.Auto,) * 2)`` and
counts the compiled step of ``repro.launch.specs.make_cell`` with
``repro.analysis.hlo_cost.analyze``; nothing in ``src/repro`` changes).
The port's: ``repro_torch.analysis.op_cost.analyze`` of
``repro_torch.launch.specs.make_cell(..., device="meta")`` as rank 0 under
a fake process group, in a subprocess of its own. Each case, a train_4k
cell at published widths, each count under its own time limit:

* the port's (1, 1) count within 10 % of the reference's, which
  calibrates the two counters against each other;
* the port's (4, 4) rank times 16 over its own (1, 1) count at most 1.05
  times the reference's ratio (1.34 for whisper-tiny, whose 6 heads do not
  divide 4 ranks; 1.00 for the others), so a rank counts no more than
  the reference's share of the work.

whisper-tiny at its published depth, granite-3-8b cut to 2 layers,
xlstm-1.3b to 8 (7 mLSTM and 1 sLSTM layer, one super-block) and
zamba2-2.7b to 6 (the shared attention and 6 Mamba2 layers), each cut
registered in each package under a test name.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("1x1", "4x4")
# arch: layers (0: published)
CASES = {"whisper-tiny": 0, "granite-3-8b": 2, "xlstm-1.3b": 8,
         "zamba2-2.7b": 6}
CALIBRATION = 0.10      # the port's (1, 1) count against the reference's
SHARE = 1.05            # the port's rank share against the reference's
TIMEOUT_S = 240         # each count, each case

PORT = r"""
import json, sys
from repro_torch.analysis import op_cost
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh
name = dryrun.at_depth(sys.argv[1], int(sys.argv[2]))
for m in sys.argv[3:]:
    shape = tuple(int(s) for s in m.split("x"))
    with dryrun.fake_group(shape[0] * shape[1]):
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        cell = specs.make_cell(name, "train_4k", mesh, device="meta")
        flops = op_cost.analyze(cell.fn, *cell.args).flops
    print(json.dumps({"mesh": list(shape), "flops": flops}))
"""


def counts(*cmds):
    """[{mesh: FLOPs} of the JSON lines each of ``cmds`` prints], each
    command in a subprocess of its own, all at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for cmd in cmds]
    got = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-2000:]
            recs = [json.loads(line) for line in out.splitlines()
                    if line.startswith("{")]
            got.append({"x".join(map(str, r["mesh"])): r["flops"]
                        for r in recs})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return got


@pytest.mark.parametrize("arch", sorted(CASES))
def test_a_rank_counts_the_reference_share(arch):
    layers = str(CASES[arch])
    # the reference's meshes in one process (one set of host devices), the
    # port's one a process, side by side
    ref, *ports = counts(
        [sys.executable, "tools/reference_rank_flops.py", "--arch", arch,
         "--layers", layers] + [a for m in MESHES for a in ("--mesh", m)],
        *[[sys.executable, "-c", PORT, arch, layers, m] for m in MESHES])
    port = {m: c for p in ports for m, c in p.items()}
    whole, rank = port["1x1"], port["4x4"]
    assert abs(whole / ref["1x1"] - 1) <= CALIBRATION, (port, ref)
    ref_ratio = ref["4x4"] * 16 / ref["1x1"]
    assert rank * 16 / whole <= SHARE * ref_ratio, (port, ref)
