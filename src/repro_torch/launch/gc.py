"""Maintenance CLI of the port: compact / vacuum a tensor store without
writing Python.

    PYTHONPATH=src python -m repro_torch.launch.gc --dir /data/lake \
        --root tensors --compact --vacuum --keep-versions 3 [--ttl 86400] \
        [--dry-run] [--device cpu]

The counterpart of ``repro.launch.gc``, option for option, on the port's
store (``--device`` is the store's device, ``cuda`` by default). A compact
pass that loses every race to concurrent writers reports it and leaves
the work to the next pass (the port's compact does not raise then). Opens
the store at ``<dir>/<root>`` (sharded or not — the store manifest
decides), optionally OPTIMIZEs every shard, then vacuums with the retention
horizon ``keep-versions``/``ttl`` computed per shard. Prints per-shard files
and bytes reclaimed. ``--dry-run`` reports without deleting. ``--spill-index``
backfills the spilled catalog index at the latest version (useful on tables
that grew large before spilling existed). ``--recompress zlib+shuffle``
rewrites every data file under that chunk-blob codec during compact — the
migration path for tables written before compression existed (run
``--vacuum`` afterwards, or in the same invocation, to reclaim the old
raw generation once retention allows). ``--build-chunk-index`` backfills
the content-addressed chunk index (``_cas/chunks.index.json``) from the
latest snapshot — the migration path for tables written before dedup
existed: afterwards, re-uploads of identical chunks (and ``put_variant``
deltas) resolve against the pre-existing objects.

Vacuum is **reference-counted**: a physical object is deleted only when
no retained or leased snapshot references it — directly, through a
deduplicated add-action (``physPath``), or as the base of a delta-stored
file (``deltaBase``, including cross-shard references). Deleting one of
several tensors sharing chunks therefore reclaims only the unshared ones.

Leases protect only readers in *this* process; the horizon policy is what
protects readers elsewhere — pick ``--keep-versions`` accordingly.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from ..core import DeltaTensorStore
from ..lake import LocalFSObjectStore
from ..lake.device import resolve_device


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="compact/vacuum a Delta tensor store")
    ap.add_argument("--dir", required=True,
                    help="object-store root directory (LocalFSObjectStore)")
    ap.add_argument("--root", default="tensor_store",
                    help="store root key prefix inside --dir")
    ap.add_argument("--compact", action="store_true",
                    help="OPTIMIZE every shard before vacuuming")
    ap.add_argument("--recompress", metavar="CODEC", default=None,
                    help="rewrite data files under this chunk-blob codec "
                         "spec during compact (e.g. zlib+shuffle; implies "
                         "--compact)")
    ap.add_argument("--vacuum", action="store_true",
                    help="delete files outside the retention horizon")
    ap.add_argument("--keep-versions", type=int, default=None,
                    help="retain the newest N versions per shard "
                         "(default: the store's recorded/default policy)")
    ap.add_argument("--ttl", type=float, default=None,
                    help="also retain versions younger than TTL seconds")
    ap.add_argument("--spill-index", action="store_true",
                    help="write the spilled catalog index at latest version")
    ap.add_argument("--build-chunk-index", action="store_true",
                    help="backfill the content-addressed chunk index from "
                         "the latest snapshot (enables dedup on tables "
                         "written before it existed)")
    ap.add_argument("--dry-run", action="store_true",
                    help="report what vacuum would delete; change nothing")
    ap.add_argument("--device", default="cuda",
                    help="the store's torch device (default cuda)")
    args = ap.parse_args(argv)

    if args.recompress:
        args.compact = True
    if not (args.compact or args.vacuum or args.spill_index
            or args.build_chunk_index):
        ap.error("nothing to do: pass --compact (or --recompress), "
                 "--vacuum, --spill-index and/or --build-chunk-index")
    if args.dry_run and args.compact:
        print("[gc] --dry-run: skipping compact (it would commit)")
    if args.dry_run and args.spill_index:
        print("[gc] --dry-run: skipping --spill-index (it would write "
              "index files)")
    if args.dry_run and args.build_chunk_index:
        print("[gc] --dry-run: skipping --build-chunk-index (it would "
              "write index files)")

    store = DeltaTensorStore(LocalFSObjectStore(args.dir), args.root,
                             device=resolve_device(args.device))
    print(f"[gc] store {args.root!r}: {store.shards} shard(s), "
          f"version {store.version()}")

    if args.build_chunk_index and not args.dry_run:
        for shard, n in enumerate(store.build_chunk_index()):
            print(f"[gc] shard {shard}: chunk index covers {n} objects")

    if args.compact and not args.dry_run:
        for shard, res in enumerate(store.compact(recompress=args.recompress)):
            if res:
                extra = (f", {res.files_recompressed} recompressed"
                         if res.files_recompressed else "")
                if res.files_skipped_shared:
                    extra += (f", {res.files_skipped_shared} shared/delta "
                              f"files left in place")
                # bytes_rewritten counts physical output bytes once, not
                # once per referencing add-action — the honest I/O bill
                print(f"[gc] shard {shard}: compacted {res.files_compacted} "
                      f"files -> {res.files_written}{extra}, "
                      f"{_fmt_bytes(res.bytes_rewritten)} rewritten "
                      f"(v{res.version})")
            elif res.lost_races:
                print(f"[gc] shard {shard}: compact lost {res.lost_races} "
                      f"races to writers; the next pass retries")
            else:
                print(f"[gc] shard {shard}: compact no-op (commit-free)")
        if args.recompress:
            stats = store.storage_stats()
            dd = stats["dedup"]
            print(f"[gc] storage after recompress: "
                  f"{_fmt_bytes(stats['physical_bytes'])} physical / "
                  f"{_fmt_bytes(stats['logical_bytes'])} logical "
                  f"({stats['ratio']:.2f}x); dedup saved "
                  f"{_fmt_bytes(dd['saved_bytes'])} across "
                  f"{dd['deduped_refs']} refs")

    if args.spill_index and not args.dry_run:
        for key in store.spill_catalog():
            print(f"[gc] spilled catalog index: {key}")

    if args.vacuum:
        results = store.vacuum(keep_versions=args.keep_versions,
                               ttl_s=args.ttl, dry_run=args.dry_run)
        verb = "would delete" if args.dry_run else "deleted"
        total_files = total_bytes = 0
        for shard, res in enumerate(results):
            total_files += res.files_deleted
            total_bytes += res.bytes_reclaimed
            print(f"[gc] shard {shard}: {verb} {res.files_deleted} files "
                  f"(+{res.index_files_deleted} indexes), "
                  f"{_fmt_bytes(res.bytes_reclaimed)}; retained versions "
                  f"{res.retained_versions[0]}..{res.retained_versions[-1]}"
                  if res.retained_versions else
                  f"[gc] shard {shard}: empty table")
        print(f"[gc] total: {verb} {total_files} files, "
              f"{_fmt_bytes(total_bytes)} reclaimed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
