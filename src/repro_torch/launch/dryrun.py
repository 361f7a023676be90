"""Dry run of the production cells: one rank of each (arch x shape x mesh)
cell, the port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's SPMD program for 256 or 512
host devices and records what XLA says one device would do. Here one
process stands for rank 0 of the mesh: it holds a ``fake`` process group
of the mesh's size (collectives return at once and move nothing), builds
the cell with :func:`.specs.make_cell` and runs its step twice, once
counted by :mod:`repro_torch.analysis.op_cost` and once timed. On
``--device cuda`` (the default) the rank's own shards of the state and the
batch live on the card and the step runs for real: the memory, the time
and the counts are real, the values are not (no other rank sent its
part). On ``--device meta`` only shapes exist: the counts are the same,
there is no time or peak memory, and the step runs once, counted.

Each record (JSON, under ``experiments/dryrun_torch/``) has the
reference's keys where they carry over: ``memory`` (the rank's argument
bytes; on cuda also its peak allocated bytes and the live bytes after the
step), ``corrected`` (op_cost's FLOPs, bytes, collective bytes and counts
by kind), ``collectives`` (bytes and counts by kind, total bytes; under
``by_op`` the bytes and counts of each kind by the op and site that caused
them, and under ``largest`` the largest single collective),
``flops_by_op`` (the FLOPs and counts by op and site, largest first),
``analytic`` (:mod:`repro_torch.analysis.accounting`), ``n_devices``,
``mesh_shape``, ``profile``; a train cell with recurrent sub-layers also
has ``row_share``: the parts a data rank's rows cut into, the ``model``
ranks that share each part, and over how many of them each recurrent kind
splits its heads (``ways``; the rest compute alike). The reference's
``lower_s`` and ``compile_s``
become ``step_s`` (a warm step's seconds; null on meta); its ``cost``
(XLA's own analysis) has no counterpart and is left out.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-tiny \\
      --shape train_4k --mesh 4x4 --device meta

``--mesh`` also takes a shape, ``4x4`` (data x model) or ``2x4x4`` (pod x
data x model). ``--layers N`` cuts each arch to N layers, widths kept,
registered as ``<arch>@<N>`` (as ``tools/reference_rank_flops.py`` names
the reference's, so the two count the same cell). Each cell runs in its
own process (``--all`` starts one per cell), since a process holds one
process group.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Iterator, Tuple

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "experiments", "dryrun_torch")
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def mesh_of(name: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``single`` / ``multi`` (the production meshes) or a shape such as
    ``4x4`` -> (shape, axis names)."""
    from .mesh import PRODUCTION
    if name in ("single", "multi"):
        return PRODUCTION[name == "multi"]
    shape = tuple(int(s) for s in name.split("x"))
    if len(shape) not in AXES:
        raise ValueError(f"mesh {name!r}: give 2 or 3 dims, as 4x4 or 2x4x4")
    return shape, AXES[len(shape)]


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """This process as rank 0 of ``world`` ranks on the ``fake`` backend,
    whose collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; run the "
                           "cell in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree: Any) -> int:
    from ..tree import leaves
    return sum(x.to_local().numel() * x.element_size()
               for _, x in leaves(tree))


def at_depth(arch: str, layers: int) -> str:
    """The name of ``arch`` cut to ``layers`` layers (registered as
    ``<arch>@<layers>``, widths kept); ``arch`` itself for 0."""
    if not layers:
        return arch
    from ..models import config as config_mod
    name = f"{arch}@{layers}"
    config_mod.register_arch(dataclasses.replace(
        config_mod.get_arch(arch), name=name, n_layers=layers))
    return name


@contextlib.contextmanager
def _holding(path: str, shared: bool = False) -> Iterator[None]:
    """A lock on the file ``path`` while the block runs, exclusive or
    ``shared`` (none where ``path`` is empty)."""
    if not path:
        yield
        return
    import fcntl
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_SH if shared else fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: str, *,
             force: bool = False, profile: str = None, tag: str = "",
             remat: str = None, device: str = "cuda",
             layers: int = 0, lock: str = "") -> Dict[str, Any]:
    """Run one cell as rank 0 of ``mesh_name`` on ``device`` and write its
    record (``arch`` cut to ``layers`` layers where that is not 0); an
    existing record is returned unless ``force``. With ``lock`` (a file)
    the cell is built and its counted step run under the file's shared
    lock, and its timed step under the exclusive one: dry runs started side
    by side build and count together, and each times its step with the
    card to itself."""
    import torch
    from ..analysis import accounting, op_cost
    from ..dist import sharding as shd
    from ..models import config as config_mod
    from ..models import ssm
    from . import specs
    from .mesh import make_mesh

    arch = at_depth(arch, layers)
    name = f"{arch}__{shape}__{mesh_name}__{device}" + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, name + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    record: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_name,
                              "device": device, "tag": tag, "status": "running"}
    cfg = config_mod.get_arch(arch)
    ok, why = specs.cell_applicable(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=why)
        _write(path, record)
        return record

    dims, axes = mesh_of(mesh_name)
    on_card = device != "meta"
    try:
        if profile or remat:
            kw = {}
            if profile:
                kw["sharding_profile"] = profile
            if remat:
                kw["remat_policy"] = remat
            cfg = dataclasses.replace(cfg, **kw)
            config_mod._REGISTRY[arch] = cfg
        if on_card:
            torch.cuda.init()
        with fake_group(math.prod(dims)):
            mesh = make_mesh(dims, axes,
                             device_type="cuda" if on_card else "cpu")
            gen = (torch.Generator(device=device).manual_seed(0)
                   if on_card else None)
            # step 1 counted (it also fills DTensor's sharding caches),
            # step 2 timed on the card (meta has no time to take); a train
            # step updates its state in place
            with _holding(lock, shared=True):
                cell = specs.make_cell(arch, shape, mesh, device=device,
                                       gen=gen)
                arg_bytes, note = _local_bytes(cell.args), cell.note
                corrected = op_cost.analyze(cell.fn, *cell.args)
            mem = {"argument_size_in_bytes": arg_bytes}
            step_s = None
            if on_card:
                with _holding(lock):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    out = cell.fn(*cell.args)
                    torch.cuda.synchronize()
                    step_s = time.perf_counter() - t0
                mem["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
                mem["allocated_after_bytes"] = torch.cuda.memory_allocated()
                del out
            del cell
        info = specs.SHAPES[shape]
        heads = ssm.recurrent_heads(cfg)
        if heads and info["kind"] == "train":
            parts, share = shd.row_share(shd.AbstractMesh(dims, axes),
                                         info["global_batch"])
            record["row_share"] = {
                "parts": parts, "share": share,
                "ways": {k: shd.head_ways(h, share) for k, h in heads.items()}}
            print(f"[{name}] recurrent rows: {record['row_share']}")
        analytic = accounting.model_flops(
            cfg, info["kind"], info["global_batch"],
            1 if info["kind"] == "decode" else info["seq_len"],
            cache_len=info["seq_len"])
        b, kind, op = corrected.largest
        coll = {"bytes_by_kind": dict(corrected.coll_bytes),
                "count_by_kind": dict(corrected.coll_count),
                "total_bytes": corrected.total_coll_bytes,
                "by_op": op_cost.by_op(corrected),
                "largest": {"bytes": b, "kind": kind, "op": op}}
        print(f"[{name}] memory: args={arg_bytes} "
              f"peak={mem.get('peak_allocated_bytes')} step_s={step_s}")
        print(f"[{name}] collectives: {coll['count_by_kind']} "
              f"total={coll['total_bytes'] / 1e9:.3f} GB, largest "
              f"{b / 1e6:.3f} MB ({kind}, {op})")
        print(f"[{name}] corrected: flops={corrected.flops:.6e} "
              f"bytes={corrected.bytes:.6e} "
              f"coll={corrected.total_coll_bytes:.6e}")
        record.update(
            status="ok", note=note,
            step_s=step_s, memory=mem, collectives=coll,
            corrected=corrected.as_dict(), analytic=analytic,
            flops_by_op=op_cost.flop_sites(corrected),
            n_devices=math.prod(dims), mesh_shape=list(dims),
            profile=profile or cfg.sharding_profile)
    except Exception as e:  # noqa: BLE001 (record and continue the sweep)
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        print(f"[{name}] FAILED: {type(e).__name__}: {e}")
    _write(path, record)
    return record


def _write(path: str, record: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def main() -> None:
    """The CLI: one cell here, or ``--all`` / several cells, one process
    each."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[None, "train_4k",
                    "prefill_32k", "decode_32k", "long_500k"])
    ap.add_argument("--mesh", default="both",
                    help="single | multi | both | a shape such as 4x4")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--profile", default=None, help="override sharding profile")
    ap.add_argument("--remat", default=None, help="override remat policy")
    ap.add_argument("--tag", default="", help="artifact suffix for perf iters")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    ap.add_argument("--device", default="cuda",
                    help="cuda (one rank's shards on the card) or meta")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth to cut each arch to (0: published)")
    ap.add_argument("--lock", default="",
                    help="a file whose lock the cell holds, shared while it "
                         "builds and counts, exclusive while it times its "
                         "step (runs started side by side then time theirs "
                         "one at a time)")
    args = ap.parse_args()

    from ..models.config import list_archs
    from .specs import SHAPES
    archs = [args.arch] if args.arch else list(list_archs())
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    if len(cells) == 1:
        r = run_cell(*cells[0], args.out, force=args.force,
                     profile=args.profile, tag=args.tag, remat=args.remat,
                     device=args.device, layers=args.layers, lock=args.lock)
        print(f"== {' × '.join(cells[0])}: {r['status']}")
        raise SystemExit(0 if r["status"] != "error" else 1)

    results = []
    for arch, shape, mesh in cells:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--out", args.out, "--device", args.device, "--tag", args.tag,
               "--layers", str(args.layers)]
        for flag, val in (("--profile", args.profile), ("--remat", args.remat)):
            if val:
                cmd += [flag, val]
        if args.force:
            cmd.append("--force")
        subprocess.run(cmd, check=False)
        name = "__".join([at_depth(arch, args.layers), shape, mesh,
                          args.device] + ([args.tag] if args.tag else []))
        with open(os.path.join(args.out, name + ".json")) as f:
            results.append(json.load(f))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = len(results) - n_ok - n_skip
    print(f"\nDRY-RUN SUMMARY: {n_ok} ok, {n_skip} skipped, {n_err} failed "
          f"of {len(results)}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
