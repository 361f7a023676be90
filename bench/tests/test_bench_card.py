"""On the card: the float8 control comes out far from the reference where
the program does not, at granite-3-8b's widths cut to 2 layers and 2 x
256 tokens a step (a size a test run holds), over three seeds; and the
profiler's trace of compressed steps yields each probed kernel's roofline
share (the compressor's three and ``adamw``) at or under 100 %. Run on
the chip: ``python -m pytest bench/tests -m card``."""

import json

import pytest

from conftest import BENCH

pytestmark = pytest.mark.card


def _cell(step):
    from yardstick import spec
    arch = json.loads((BENCH / "configs" / "granite-3-8b.json").read_text())["arch"]
    mix = json.loads((BENCH / "traffic" / "bsgs_sft.json").read_text())
    mix = dict(mix, step=step, rows=2, table_rows=64)
    return spec.Cell(name="granite-3-8b.test", chips=1,
                     config={"arch": dict(arch, n_layers=2)}, mix=mix,
                     end_to_end=[], per_layer=[], limits={})


@pytest.mark.parametrize("step", ["bsgs", "plain"])
def test_control_far_from_reference_where_program_is_near(card, step):
    import calibrate
    from conftest import ROOT
    cell = _cell(step)
    prog = [calibrate.readings(cell, s, "program", card, ROOT)[0] for s in (1, 2, 3)]
    ctrl = [calibrate.readings(cell, s, "control", card, ROOT)[0] for s in (1, 2, 3)]
    worst_prog = max(max(r["loss_gap"], r["grad_gap"]) for r in prog)
    for r in ctrl:
        assert max(r["loss_gap"], r["grad_gap"]) > 3 * worst_prog, (prog, ctrl)
    if step == "bsgs":
        assert all(r["tiles_sent_gap"] == 0 for r in prog)


def test_kernel_rooflines_at_most_100(card, tmp_path):
    from types import SimpleNamespace
    from yardstick import cell as run_cell
    from yardstick import program, spec
    cell = _cell("bsgs")
    s = run_cell.setup(cell, 7, card, {})
    run_cell.check_steps(s, cell, 7, card)
    from yardstick import probes as kernel_probes
    probes = program.Probes(f"{k}_roofline" for k in kernel_probes.names())
    trace = run_cell.profiled_steps(s, 2, run_cell.Clock(card), probes)
    run = SimpleNamespace(trace=trace, kernel_bytes=probes.kernel_bytes(),
                          kernel_flops=probes.kernel_flops(), mix=cell.mix)
    assert {"block_norms", "block_gather", "block_scatter", "adamw"} <= set(run.kernel_bytes)
    for k in run.kernel_bytes:
        share = spec.reader(BENCH.parent, f"{k}_roofline")(run)
        assert share is not None and 0 < share <= 100, (k, share)
    s.close()
