"""parq-lite: a minimal Parquet-style columnar file format.

The paper leans on two Parquet behaviours: (1) hybrid row/column layout so a
row-group can be fetched and then decoded column-by-column, and (2)
dictionary/RLE encoding so per-row metadata that repeats across rows ("the
same dense_shape on every row of a tensor") compresses to almost nothing.
parq-lite reproduces exactly those two behaviours with stdlib-only code:

    file := magic "PQL1" | u32 header_len | header JSON | column blocks

Column kinds
  array : one fixed-dtype scalar per row               (chunk_index, nnz, ...)
  list  : one variable-length 1-D array per row        (dimensions, indices)
  bytes : one blob per row                              (chunk payloads)
  str   : one unicode string per row                    (id, layout)

Encodings (chosen automatically per column):
  plain : raw buffer
  dict  : unique values + per-row codes    — the Parquet dictionary page
  rle   : (value, run_length) pairs        — repeated/sorted columns (id)

Each block is optionally zlib-compressed when that actually shrinks it.
min/max stats are computed per column at write time and returned to the
caller so the delta log can store them for data skipping (the reader never
needs to fetch a file whose [min,max] chunk_index range misses the slice).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"PQL1"

# ---------------------------------------------------------------------------
# block encoders
# ---------------------------------------------------------------------------


def _maybe_compress(raw: bytes) -> Tuple[bytes, bool]:
    if len(raw) < 64:
        return raw, False
    comp = zlib.compress(raw, 3)
    if len(comp) < len(raw) * 0.9:
        return comp, True
    return raw, False


def _decompress(raw: bytes, compressed: bool) -> bytes:
    return zlib.decompress(raw) if compressed else raw


def _pack_arrays(arrays: Sequence[np.ndarray]) -> bytes:
    """Concatenate buffers with a small length-prefixed framing."""
    parts = [struct.pack("<I", len(arrays))]
    for a in arrays:
        buf = np.ascontiguousarray(a).tobytes()
        parts.append(struct.pack("<Q", len(buf)))
        parts.append(buf)
    return b"".join(parts)


def _unpack_arrays(raw: bytes, dtypes: Sequence[str]) -> List[np.ndarray]:
    (n,) = struct.unpack_from("<I", raw, 0)
    off = 4
    out = []
    for i in range(n):
        (ln,) = struct.unpack_from("<Q", raw, off)
        off += 8
        out.append(np.frombuffer(raw, dtype=dtypes[i], count=ln // np.dtype(dtypes[i]).itemsize, offset=off).copy())
        off += ln
    return out


def _min_code_dtype(n: int) -> str:
    if n < 2**8:
        return "uint8"
    if n < 2**16:
        return "uint16"
    return "uint32"


def _encode_array(values: np.ndarray) -> Tuple[bytes, Dict[str, Any]]:
    """Pick plain/dict/rle for a 1-D fixed-dtype array."""
    values = np.asarray(values)
    n = len(values)
    meta: Dict[str, Any] = {"dtype": str(values.dtype), "rows": n}
    if n == 0:
        meta["encoding"] = "plain"
        return b"", meta

    plain_sz = values.nbytes
    # float payloads (tensor values) essentially never dict/RLE-compress and
    # np.unique on 100M+ elements costs seconds — leave those to zlib
    heavy = values.nbytes > (8 << 20) or values.dtype.kind == "f"
    if heavy:
        return values.tobytes(), dict(meta, encoding="plain")

    # run-length candidate
    change = np.flatnonzero(np.concatenate(([True], values[1:] != values[:-1])))
    n_runs = len(change)
    # dictionary candidate
    uniques, codes = np.unique(values, return_inverse=True)
    n_uniq = len(uniques)

    rle_sz = n_runs * (values.itemsize + 4)
    dict_sz = n_uniq * values.itemsize + n * np.dtype(_min_code_dtype(n_uniq)).itemsize

    best = min(plain_sz, rle_sz, dict_sz)
    if best == rle_sz and rle_sz < plain_sz:
        run_vals = values[change]
        run_lens = np.diff(np.concatenate((change, [n]))).astype("uint32")
        raw = _pack_arrays([run_vals, run_lens])
        meta["encoding"] = "rle"
    elif best == dict_sz and dict_sz < plain_sz:
        code_dt = _min_code_dtype(n_uniq)
        raw = _pack_arrays([uniques, codes.astype(code_dt)])
        meta["encoding"] = "dict"
        meta["code_dtype"] = code_dt
    else:
        raw = values.tobytes()
        meta["encoding"] = "plain"
    return raw, meta


def _decode_array(raw: bytes, meta: Dict[str, Any]) -> np.ndarray:
    dt = meta["dtype"]
    if meta["rows"] == 0:
        return np.empty(0, dtype=dt)
    enc = meta["encoding"]
    if enc == "plain":
        return np.frombuffer(raw, dtype=dt).copy()
    if enc == "rle":
        run_vals, run_lens = _unpack_arrays(raw, [dt, "uint32"])
        return np.repeat(run_vals, run_lens)
    if enc == "dict":
        uniques, codes = _unpack_arrays(raw, [dt, meta["code_dtype"]])
        return uniques[codes]
    raise ValueError(f"unknown encoding {enc}")


# ---------------------------------------------------------------------------
# column-level encode/decode
# ---------------------------------------------------------------------------


def _stats_of(values: np.ndarray) -> Optional[Dict[str, Any]]:
    if values.size == 0 or values.dtype.kind not in "iuf":
        return None
    return {"min": values.min().item(), "max": values.max().item()}


def _encode_column(name: str, col: Any, num_rows: int, *,
                   compress_blocks: bool = True) -> Tuple[bytes, Dict[str, Any]]:
    # --- classify ---
    if isinstance(col, np.ndarray) and col.ndim == 1 and col.dtype.kind != "O":
        kind = "array"
    elif len(col) and isinstance(col[0], (bytes, bytearray, memoryview)):
        kind = "bytes"
    elif len(col) and isinstance(col[0], str):
        kind = "str"
    elif isinstance(col, np.ndarray) and col.dtype.kind == "O" or isinstance(col, (list, tuple)):
        kind = "list"
    elif isinstance(col, np.ndarray) and col.ndim == 1:
        kind = "array"
    else:
        raise TypeError(f"column {name!r}: unsupported value {type(col)}")
    if len(col) != num_rows:
        raise ValueError(f"column {name!r}: {len(col)} rows != {num_rows}")

    meta: Dict[str, Any] = {"name": name, "kind": kind}
    if kind == "array":
        raw, emeta = _encode_array(np.asarray(col))
        meta.update(emeta)
        meta["stats"] = _stats_of(np.asarray(col))
    elif kind == "str":
        # dictionary-encode strings through their codes
        arr = np.asarray(col, dtype=object)
        uniques, codes = np.unique(arr, return_inverse=True)
        code_raw, emeta = _encode_array(codes.astype("uint32"))
        udata = "\x00".join(str(u) for u in uniques).encode("utf-8")
        raw = struct.pack("<Q", len(udata)) + udata + code_raw
        meta["code_meta"] = emeta
        meta["dtype"] = "str"
        meta["rows"] = num_rows
    elif kind == "bytes":
        offsets = np.zeros(num_rows + 1, dtype="uint64")
        for i, b in enumerate(col):
            offsets[i + 1] = offsets[i] + len(b)
        body = b"".join(bytes(b) for b in col)
        raw = _pack_arrays([offsets]) + body
        meta["dtype"] = "bytes"
        meta["rows"] = num_rows
    else:  # list
        arrays = [np.asarray(a) for a in col]
        dt = np.result_type(*[a.dtype for a in arrays]) if arrays else np.dtype("int64")
        flat = (np.concatenate([a.astype(dt, copy=False).ravel() for a in arrays])
                if arrays else np.empty(0, dt))
        lens = np.asarray([a.size for a in arrays], dtype="uint32")
        len_raw, len_meta = _encode_array(lens)
        flat_raw, flat_meta = _encode_array(flat)
        raw = struct.pack("<Q", len(len_raw)) + len_raw + flat_raw
        meta["rows"] = num_rows
        meta["dtype"] = str(dt)
        meta["len_meta"] = len_meta
        meta["flat_meta"] = flat_meta
        meta["stats"] = _stats_of(flat)

    comp, was = _maybe_compress(raw) if compress_blocks else (raw, False)
    meta["compressed"] = was
    return comp, meta


def _decode_column(raw: bytes, meta: Dict[str, Any]) -> Any:
    raw = _decompress(raw, meta["compressed"])
    kind = meta["kind"]
    if kind == "array":
        return _decode_array(raw, meta)
    if kind == "str":
        (ulen,) = struct.unpack_from("<Q", raw, 0)
        udata = bytes(raw[8:8 + ulen]).decode("utf-8")
        uniques = np.asarray(udata.split("\x00"), dtype=object) if ulen else np.asarray([""], dtype=object)
        codes = _decode_array(raw[8 + ulen:], meta["code_meta"])
        return uniques[codes]
    if kind == "bytes":
        (n,) = struct.unpack_from("<I", raw, 0)
        (ln,) = struct.unpack_from("<Q", raw, 4)
        offsets = np.frombuffer(raw, dtype="uint64", count=ln // 8, offset=12)
        body_start = 12 + ln
        return [raw[body_start + int(offsets[i]): body_start + int(offsets[i + 1])]
                for i in range(meta["rows"])]
    if kind == "list":
        (ln,) = struct.unpack_from("<Q", raw, 0)
        lens = _decode_array(raw[8:8 + ln], meta["len_meta"])
        flat = _decode_array(raw[8 + ln:], meta["flat_meta"])
        splits = np.cumsum(lens)[:-1].astype(np.int64)
        return np.split(flat, splits)
    raise ValueError(f"unknown kind {kind}")


# ---------------------------------------------------------------------------
# file-level API
# ---------------------------------------------------------------------------


def write_table(columns: Dict[str, Any], *,
                compress_blocks: bool = True) -> Tuple[bytes, Dict[str, Any]]:
    """Encode a column dict into a parq-lite file.

    Returns (file_bytes, stats) where stats = {column: {min,max}} for numeric
    columns — callers persist these in the delta-log add-action for skipping.

    ``compress_blocks=False`` skips the built-in opportunistic per-block
    zlib: callers that frame the whole file under a file-level codec (see
    :mod:`repro_torch.lake.compression`) must hand it raw blocks, or the outer
    codec would grind against already-compressed high-entropy bytes.
    """
    if not columns:
        raise ValueError("empty table")
    num_rows = len(next(iter(columns.values())))
    blocks: List[bytes] = []
    metas: List[Dict[str, Any]] = []
    offset = 0
    for name, col in columns.items():
        raw, meta = _encode_column(name, col, num_rows,
                                   compress_blocks=compress_blocks)
        meta["offset"] = offset
        meta["length"] = len(raw)
        offset += len(raw)
        blocks.append(raw)
        metas.append(meta)
    header = json.dumps({"num_rows": num_rows, "columns": metas},
                        separators=(",", ":")).encode("utf-8")
    out = b"".join([MAGIC, struct.pack("<I", len(header)), header] + blocks)
    stats = {m["name"]: m["stats"] for m in metas if m.get("stats")}
    return out, {"num_rows": num_rows, "column_stats": stats}


def _header(data: bytes) -> Tuple[Dict[str, Any], int]:
    if data[:4] != MAGIC:
        raise ValueError("not a parq-lite file")
    (hlen,) = struct.unpack_from("<I", data, 4)
    # bytes(): json.loads rejects memoryviews, which the zero-copy frame
    # decode path now hands us
    header = json.loads(bytes(data[8:8 + hlen]))
    return header, 8 + hlen


def read_table(data: bytes, columns: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Decode a parq-lite file; optionally project a subset of columns."""
    header, base = _header(data)
    want = set(columns) if columns is not None else None
    out: Dict[str, Any] = {}
    for meta in header["columns"]:
        if want is not None and meta["name"] not in want:
            continue
        raw = data[base + meta["offset"]: base + meta["offset"] + meta["length"]]
        out[meta["name"]] = _decode_column(raw, meta)
    if want is not None and want - set(out):
        raise KeyError(f"missing columns: {sorted(want - set(out))}")
    return out


def num_rows(data: bytes) -> int:
    """Row count of a parq-lite file, read from the header only."""
    return _header(data)[0]["num_rows"]
