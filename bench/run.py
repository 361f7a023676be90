#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration (``bench/configs/``) and traffic mix (``bench/traffic/``).
The run draws the weights and the token table from ``--seed``, writes the
table to a store under ``TMPDIR``, streams it onto the card through the
store's loader, drives the program's train step through three checked
steps, then through a window of ``--seconds``, and compares the checked
steps with the plain reference (``bench/yardstick/reference``). With
``--trace 1`` a few more steps run under ``torch.profiler`` and the
result carries the cell's per-layer metrics (``bench/metrics/``) instead
of its end-to-end ones. The last line of standard output is one JSON
object; the last lines of standard error give each compared number
beside its limit. A host without enough CUDA cards fails, printing no
result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN`` (the
    part before the first dot, compared whole: ``repro_torch`` is not
    ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info(torch):
    """(name, power limit, count) of the visible cards."""
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        limit = f"not read ({e})"
    return torch.cuda.get_device_name(0), limit, torch.cuda.device_count()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, root: Path = ROOT, device: str = "cuda",
         make_step=None, plant=None) -> int:
    """One run; returns the exit code. ``device="cpu"`` skips the look for
    a card (the CPU tests); ``make_step`` and ``plant(feed)`` break the
    timed path underneath (the tests' faults)."""
    args = parse(argv)
    if args.seed < 0:
        log(f"--seed must be non-negative, got {args.seed}")
        return 2
    sys.path.insert(0, str(root / "src"))
    t = time.perf_counter()
    import torch
    from yardstick import cell as run_cell
    from yardstick import program, spec, stats
    try:
        import repro_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        log(f"the program under test is not in this checkout: {e}")
        return 2
    times = {"imports": time.perf_counter() - t}
    cell = spec.load(root, args.workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            log("torch.cuda.is_available() is false: no card, no result")
            return 2
        if torch.cuda.device_count() < cell.chips:
            log(f"{torch.cuda.device_count()} cards, the cell needs {cell.chips}")
            return 2
        kind, limit, count = card_info(torch)
        log(f"card: {kind}, power limit {limit}, {count} visible, "
            f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    else:
        kind, count = "cpu", 1
    mix, arch = cell.mix, cell.config["arch"]
    tokens = mix["rows"] * mix["seq_len"]
    clock = run_cell.Clock(dev)

    s = run_cell.setup(cell, args.seed, dev, times, make_step)
    if plant is not None:
        plant(s.feed)
    t = time.perf_counter()
    prog = run_cell.check_steps(s, cell, args.seed, dev)
    times["warm_steps"] = time.perf_counter() - t
    clock.sync()
    if dev.type == "cuda":
        peak_setup = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T0
    log("set-up s: " + ", ".join(f"{k} {v!r}" for k, v in times.items())
        + f"; process start to the window {setup_s!r}")

    win = run_cell.window(s, args.seconds, clock, tokens)
    gaps = stats.step_gaps_ms(win.start_ms, win.ends_ms)
    log(f"window: {win.steps} steps of {tokens} tokens in "
        f"{win.ends_ms[-1] / 1e3!r} s; step ms p10 / p50 / p90 / max "
        + " / ".join(repr(stats.percentile(gaps, q)) for q in (10, 50, 90, 100)))
    half = win.steps // 2
    if half:
        log(f"window halves: tokens/s "
            f"{stats.window_rate(tokens, win.start_ms, win.ends_ms[:half])!r} / "
            f"{stats.window_rate(tokens, win.ends_ms[half - 1], win.ends_ms[half:])!r}")
    peak_window = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    trace = None
    probes = program.Probes(m["name"] for m in cell.per_layer)
    if args.trace:
        trace = run_cell.profiled_steps(s, mix["profile_steps"], clock, probes)
        for st in probes.compress_stats[-1:]:
            log(f"the program's own wire ratio (stats): "
                f"{st['sent_bytes'] / st['dense_bytes']!r}")
    clock.sync()
    found = forbidden_modules()
    if found:
        log(f"modules loaded that the benchmark may not load: {found}")
        return 3
    memory_peak = max(peak_setup, peak_window) if dev.type == "cuda" else 0

    # the window is closed: check the batches, free the program, run the
    # reference and compare
    mismatch = run_cell.batch_mismatch(s.feed, s.table, dev)
    samples = [ids for _, ids in s.feed.kept[:run_cell.CHECK_STEPS]]
    table = s.table
    kernel_bytes = probes.kernel_bytes() if args.trace else {}
    kernel_flops = probes.kernel_flops() if args.trace else {}
    s.close()
    del s
    run_cell.release()
    t = time.perf_counter()
    ref = run_cell.reference_readings(cell, args.seed, table, samples, dev)
    ref_s = time.perf_counter() - t
    numbers = run_cell.compare(prog, ref, cell)
    numbers["batch_mismatch"] = float(mismatch)
    numbers["failed_steps"] = float(win.failed)
    limits = dict(cell.limits, batch_mismatch=0.0, failed_steps=0.0)
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    run = SimpleNamespace(cell=cell, arch=arch, mix=mix, window=win,
                          setup_s=setup_s, times=times, trace=trace,
                          kernel_bytes=kernel_bytes, kernel_flops=kernel_flops,
                          probes=probes,
                          peak_window_bytes=peak_window)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": win.steps, "failed": win.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": kind, "count": 1,
                         "memory_peak_bytes": memory_peak}}
    if trace is not None:
        busy, span = trace.busy_seconds(), trace.span()
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = (span[1] - span[0]) / 1e6 if span else None
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["setup_parts_s"] = times
    result["reference_s"] = ref_s
    result["readings"] = {"program": prog, "reference": ref}
    result["checks"] = checks
    log(f"reference {ref_s!r} s: {ref['seconds']}")
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {correct}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
