"""One device's share of a train cell in the JAX reference, as XLA compiles it.

Builds a ``("data", "model")`` mesh of host CPU devices (``("pod", "data",
"model")`` for a 3-D ``--mesh`` such as ``2x16x16``) with Auto axes
(``jax.make_mesh`` defaults to Explicit axes, under which the reference
trainer's ``with_sharding_constraint`` raises), compiles
``repro.launch.specs.make_cell(arch, shape, mesh)`` and counts the
compiled per-device program with ``repro.analysis.hlo_cost.analyze``
(trip-corrected FLOPs, collective bytes). Nothing is run. ``--layers``
registers the arch at that depth under the name ``<arch>@<layers>``,
widths kept. The port's own count of a rank is
``repro_torch.analysis.op_cost`` of ``repro_torch.launch.specs.make_cell``.

Usage (one JSON line per mesh on stdout)::

  PYTHONPATH=src python tools/reference_rank_flops.py --arch whisper-tiny \\
      --mesh 1x1 --mesh 4x4
  PYTHONPATH=src python tools/reference_rank_flops.py --arch granite-3-8b \\
      --mesh 16x16
  PYTHONPATH=src python tools/reference_rank_flops.py --arch zamba2-2.7b \\
      --layers 6 --mesh 2x16x16
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", action="append", required=True,
                    help="data x model, as 4x4, or pod x data x model, as "
                         "2x16x16; repeat for several")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth to cut the arch to (0: published)")
    args = ap.parse_args()
    meshes = [tuple(int(s) for s in m.split("x")) for m in args.mesh]
    if any(len(m) not in AXES for m in meshes):
        ap.error("--mesh takes 2 or 3 dims, as 4x4 or 2x16x16")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count="
                               f"{max(math.prod(m) for m in meshes)}")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import dataclasses

    import jax
    from jax.sharding import AxisType

    from repro.analysis import hlo_cost
    from repro.launch import specs
    from repro.models import config

    name = args.arch
    if args.layers:
        name = f"{args.arch}@{args.layers}"
        config.register_arch(dataclasses.replace(
            config.get_arch(args.arch), name=name, n_layers=args.layers))
    for shape in meshes:
        t0 = time.perf_counter()
        mesh = jax.make_mesh(shape, AXES[len(shape)],
                             axis_types=(AxisType.Auto,) * len(shape))
        cell = specs.make_cell(name, args.shape, mesh)
        with mesh:
            step = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                           out_shardings=cell.out_shardings,
                           donate_argnums=cell.donate)
            compiled = step.lower(*cell.args).compile()
        c = hlo_cost.analyze(compiled.as_text())
        print(json.dumps({"arch": args.arch, "layers": args.layers,
                          "shape": args.shape, "mesh": list(shape),
                          "flops": c.flops, "coll_bytes": c.total_coll_bytes,
                          "compile_s": time.perf_counter() - t0}))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
