"""Streaming-ingest CLI of the port: append rows to a tensor with watermark
commits.

    PYTHONPATH=src python -m repro_torch.launch.ingest --dir /data/lake \
        --root tensors --tensor events --rows 4096 --row-shape 64,8 \
        --watermark-rows 256 [--watermark-s 5] [--batch-rows 32] \
        [--device cpu]

The counterpart of ``repro.launch.ingest``, option for option, on the
port's store (``--device`` is the store's device, ``cuda`` by default; the
rows themselves are host data). Opens (or creates) the store at
``<dir>/<root>`` and drives an
:class:`~repro_torch.data.ingest.IngestWriter` with synthetic rows: the producer
appends ``--batch-rows`` rows at a time and the writer commits a new table
version whenever the row or time watermark is crossed. Readers are never
blocked — each commit is an ordinary fenced Delta version, so a
``StreamLoader`` (or a second ``ingest`` process) pointed at the same
tensor keeps working off its pinned snapshot and picks up the new rows on
``reopen()``.

The writer is crash-consistent: killing this process at any point leaves
either fully committed rows or invisible uploads that
``repro_torch.launch.gc --vacuum`` reclaims. Re-running with the same arguments
resumes from the committed row count (the banner prints it), so a producer
that replays its stream from that offset never duplicates a row.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np

from ..core import DeltaTensorStore
from ..lake import LocalFSObjectStore
from ..lake.device import resolve_device


def _parse_shape(text: str) -> tuple:
    try:
        shape = tuple(int(p) for p in text.split(",") if p.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(f"bad shape {text!r}") from None
    if not shape or any(d <= 0 for d in shape):
        raise argparse.ArgumentTypeError(f"bad shape {text!r}")
    return shape


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="stream synthetic rows into a tensor with watermark "
                    "commits")
    ap.add_argument("--dir", required=True,
                    help="object-store root directory (LocalFSObjectStore)")
    ap.add_argument("--root", default="tensor_store",
                    help="store root key prefix inside --dir")
    ap.add_argument("--tensor", required=True, help="tensor id to ingest into")
    ap.add_argument("--rows", type=int, default=1024,
                    help="total rows to append this run")
    ap.add_argument("--row-shape", type=_parse_shape, default=(64,),
                    help="shape of ONE row, comma-separated (e.g. 64,8); "
                         "ignored when the tensor already exists")
    ap.add_argument("--dtype", default="float32",
                    help="row dtype for a new tensor (default float32)")
    ap.add_argument("--batch-rows", type=int, default=32,
                    help="rows per producer append call")
    ap.add_argument("--watermark-rows", type=int, default=256,
                    help="commit whenever this many rows are buffered")
    ap.add_argument("--watermark-s", type=float, default=None,
                    help="also commit when the oldest buffered row is this "
                         "old (seconds)")
    ap.add_argument("--target-file-bytes", type=int, default=None,
                    help="split sealed batches into files of about this "
                         "many bytes")
    ap.add_argument("--compression", default=None,
                    help="chunk-blob codec spec for new files "
                         "(e.g. zlib+shuffle)")
    ap.add_argument("--seed", type=int, default=0, help="synthetic-data seed")
    ap.add_argument("--device", default="cuda",
                    help="the store's torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.rows <= 0 or args.batch_rows <= 0:
        ap.error("--rows and --batch-rows must be positive")

    store = DeltaTensorStore(LocalFSObjectStore(args.dir), args.root,
                             compression=args.compression,
                             device=resolve_device(args.device))
    with store.ingest(args.tensor,
                      watermark_rows=args.watermark_rows,
                      watermark_s=args.watermark_s,
                      target_file_bytes=args.target_file_bytes) as w:
        if w.row_count and w._row_shape is not None:
            shape, dtype = w._row_shape, w._dtype
            print(f"[ingest] resuming {args.tensor!r} at committed row "
                  f"{w.row_count} (row shape {tuple(shape)}, {dtype})")
        else:
            shape, dtype = args.row_shape, np.dtype(args.dtype)
            print(f"[ingest] creating {args.tensor!r} (row shape "
                  f"{tuple(shape)}, {dtype})")
        rng = np.random.default_rng(args.seed + w.row_count)
        t0 = time.perf_counter()
        done = 0
        while done < args.rows:
            k = min(args.batch_rows, args.rows - done)
            if np.issubdtype(dtype, np.floating):
                batch = rng.standard_normal((k,) + tuple(shape)).astype(dtype)
            else:
                batch = rng.integers(0, 2 ** 15, size=(k,) + tuple(shape),
                                     dtype=dtype)
            w.append_rows(batch)
            done += k
        w.close()
        dt = max(time.perf_counter() - t0, 1e-9)
        s = w.stats()
        print(f"[ingest] appended {done} rows in {dt:.2f}s "
              f"({done / dt:.0f} rows/s) across {s['flushes']} commits "
              f"({s['conflicts']} conflicts, {s['reencodes']} re-encodes)")
        print(f"[ingest] {args.tensor!r} now has {w.row_count} rows at "
              f"version {w.version}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
