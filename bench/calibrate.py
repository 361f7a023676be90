#!/usr/bin/env python3
"""Readings that a cell's limits are set from, many seeds in one process.

    python3 bench/calibrate.py --workload <cell> --side <side> --seeds a,b,c

``--side program`` runs the program's three checked steps (the set-up of
``run.py``, no window) and the reference on each seed; ``control`` puts
the reference computed with float8 matmuls in the program's place;
``half`` runs the program on the first half of each batch only (the mean
over the rest); ``frozen`` runs the program with its optimizer update
left out, so every step returns its state unchanged; ``no_residual`` runs
the compressed program with its error feedback dropped (each step keeps a
zero residual). Each seed prints one
JSON line: the compared numbers (``yardstick.cell.compare``). The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def half_step(make):
    """The program's step fed the first half of each batch: its first
    half of rows, or of positions where a batch is one row."""
    def half(v):
        return v[:v.shape[0] // 2] if v.shape[0] > 1 else v[:, :v.shape[1] // 2]

    def make_step(mix, cfg):
        step = make(mix, cfg)
        return lambda state, batch: step(state, {k: half(v) for k, v in batch.items()})
    return make_step


def frozen_step(make):
    """The program's step with its optimizer update left out."""
    def make_step(mix, cfg):
        from repro_torch.train import optimizer
        step = make(mix, cfg)

        def unchanged(cfg, grads, state, params, **kw):
            zero = state.count.float() * 0
            return params, state, {"lr": zero, "grad_norm": zero}

        def run(state, batch):
            orig, optimizer.update = optimizer.update, unchanged
            try:
                return step(state, batch)
            finally:
                optimizer.update = orig
        return run
    return make_step


def no_residual_step(make):
    """The program's compressed step keeping a zero residual: what a step
    did not send is dropped instead of carried to the next."""
    def make_step(mix, cfg):
        from repro_torch.train import grad_compress
        from repro_torch.tree import tree_map
        step = make(mix, cfg)

        def run(state, batch):
            orig = grad_compress.compressed_grad_mean

            def dropped(*args, **kw):
                mean, new_r, stats = orig(*args, **kw)
                return mean, tree_map(lambda r: r.zero_(), new_r), stats
            grad_compress.compressed_grad_mean = dropped
            try:
                return step(state, batch)
            finally:
                grad_compress.compressed_grad_mean = orig
        return run
    return make_step


def readings(cell, seed: int, side: str, dev, root: Path):
    from yardstick import cell as run_cell
    from yardstick import program
    from yardstick.reference import model as ref_model
    times = {}
    if side == "control":
        s = run_cell.setup(cell, seed, dev, times)
        s.state = None
        samples = []
        for _ in range(run_cell.CHECK_STEPS):
            s.feed()
            samples.append(s.feed.kept[-1][1])
        table = s.table
        s.close()
        del s
        run_cell.release()
        prog = run_cell.reference_readings(cell, seed, table, samples, dev,
                                           mm=ref_model.fp8_matmul)
    else:
        make = {"program": program.make_step, "half": half_step(program.make_step),
                "frozen": frozen_step(program.make_step),
                "no_residual": no_residual_step(program.make_step)}[side]
        s = run_cell.setup(cell, seed, dev, times, make)
        prog = run_cell.check_steps(s, cell, seed, dev)
        samples = [ids for _, ids in s.feed.kept[:run_cell.CHECK_STEPS]]
        table = s.table
        s.close()
        del s
        run_cell.release()
    ref = run_cell.reference_readings(cell, seed, table, samples, dev)
    run_cell.release()
    return run_cell.compare(prog, ref, cell), prog, ref


def main(argv=None, *, root: Path = ROOT, device: str = "cuda") -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", choices=("program", "control", "half", "frozen",
                                      "no_residual"),
                   required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--full", action="store_true",
                   help="print every leaf's readings too")
    args = p.parse_args(argv)
    sys.path.insert(0, str(root / "src"))
    import torch
    from yardstick import spec
    cell = spec.load(root, args.workload)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        numbers, prog, ref = readings(cell, seed, args.side, dev, root)
        line = {"workload": cell.name, "side": args.side, "seed": seed,
                "numbers": numbers, "seconds": time.perf_counter() - t}
        if args.full:
            line["program"], line["reference"] = prog, ref
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
