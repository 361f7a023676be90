"""CSR/CSC (paper §IV.D) — flatten to 2-D, compress row- or column-wise.

The tensor is reshaped to a 2-D matrix: the first ``split`` dims become
rows, the rest become columns (``flattened_shape``); CSR's three arrays
(``value``, ``col_indices``, ``crow_indices``) are then chunked into table
rows along matrix-row boundaries ("encoding before partitioning", as the
paper groups it). Each chunk row records its ``[row_start, row_end)`` so a
leading-dim slice prunes chunk files by range. CSC is CSR of the transpose.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from .base import (Codec, RowGroup, SliceSpec, SparseCOO, as_coo, first_scalar,
                   header_shape, make_header, normalize_slices, register,
                   split_groups)

TARGET_NNZ_PER_CHUNK = 1 << 18


def _flatten_coo(t: SparseCOO, split: int, transpose: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    rows_shape = t.shape[:split] or (1,)
    cols_shape = t.shape[split:] or (1,)
    n_rows = int(np.prod(rows_shape))
    n_cols = int(np.prod(cols_shape))
    if t.nnz:
        r = np.ravel_multi_index([t.indices[:, d] for d in range(split)], rows_shape) \
            if split else np.zeros(t.nnz, dtype=np.int64)
        c = np.ravel_multi_index([t.indices[:, d] for d in range(split, t.ndim)], cols_shape) \
            if split < t.ndim else np.zeros(t.nnz, dtype=np.int64)
    else:
        r = c = np.zeros(0, dtype=np.int64)
    if transpose:
        r, c = c, r
        n_rows, n_cols = n_cols, n_rows
    return r.astype(np.int64), c.astype(np.int64), np.asarray(t.values), (n_rows, n_cols)


class CSRCodec(Codec):
    """Compressed sparse rows for matrices (paper §IV.C)."""

    layout = "csr"
    transpose = False
    supports_slice = True
    supports_coo = True

    def encode(self, tensor: Any, *, split: int = 1, **_) -> List[RowGroup]:
        """Tensor -> row groups (header + chunk rows)."""
        t = as_coo(tensor)
        r, c, v, (n_rows, n_cols) = _flatten_coo(t, split, self.transpose)
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
        # chunk along row boundaries targeting ~TARGET_NNZ_PER_CHUNK nnz each
        groups: List[RowGroup] = []
        starts = [0]
        while starts[-1] < len(v):
            nxt = min(len(v), starts[-1] + TARGET_NNZ_PER_CHUNK)
            if nxt < len(v):  # align up to the end of the current matrix row
                row_at = r[nxt - 1]
                nxt = int(np.searchsorted(r, row_at, side="right"))
            starts.append(max(nxt, starts[-1] + 1))
        bounds = list(zip(starts[:-1], starts[1:])) or [(0, 0)]
        cols_rows: Dict[str, Any] = {k: [] for k in
                                     ("row_start", "row_end", "nnz_start", "value",
                                      "col_indices", "crow_local")}
        for s, e in bounds:
            rs = int(r[s]) if e > s else 0
            re_ = int(r[e - 1]) + 1 if e > s else 0
            local_rows = re_ - rs
            crow = np.zeros(local_rows + 1, dtype=np.int64)
            if e > s:
                counts = np.bincount(r[s:e] - rs, minlength=local_rows)
                crow[1:] = np.cumsum(counts)
            cols_rows["row_start"].append(rs)
            cols_rows["row_end"].append(re_)
            cols_rows["nnz_start"].append(s)
            cols_rows["value"].append(v[s:e])
            cols_rows["col_indices"].append(c[s:e])
            cols_rows["crow_local"].append(crow)
        n_chunks = len(bounds)
        chunk_cols: Dict[str, Any] = {
            "row_start": np.asarray(cols_rows["row_start"], dtype=np.int64),
            "row_end": np.asarray(cols_rows["row_end"], dtype=np.int64),
            "nnz_start": np.asarray(cols_rows["nnz_start"], dtype=np.int64),
            "value": cols_rows["value"],
            "col_indices": cols_rows["col_indices"],
            "crow_local": cols_rows["crow_local"],
            "dense_shape": [np.asarray(t.shape, dtype=np.int64)] * n_chunks,
            "flattened_shape": [np.asarray((n_rows, n_cols), dtype=np.int64)] * n_chunks,
            "split": np.full(n_chunks, split, dtype=np.int32),
        }
        header = make_header(t.shape, v.dtype, split=split,
                             flattened_shape=np.asarray((n_rows, n_cols), np.int64))
        return [header, RowGroup(kind="chunk", columns=chunk_cols,
                                 skip_columns=("row_start", "row_end"))]

    # -- decode ----------------------------------------------------------------

    def _gather(self, groups: List[Dict[str, Any]]):
        header, groups = split_groups(groups)
        shape = header_shape(header)
        flat = tuple(int(x) for x in header["flattened_shape"][0])
        split = int(first_scalar(header["split"]))
        rows, cols, vals = [], [], []
        for g in groups:
            for i in range(len(g["row_start"])):
                rs = int(np.asarray(g["row_start"])[i])
                crow = np.asarray(g["crow_local"][i])
                v = np.asarray(g["value"][i])
                c = np.asarray(g["col_indices"][i])
                local_rows = len(crow) - 1
                r = np.repeat(np.arange(rs, rs + local_rows), np.diff(crow))
                rows.append(r)
                cols.append(c)
                vals.append(v)
        if rows:
            r = np.concatenate(rows)
            c = np.concatenate(cols)
            v = np.concatenate(vals)
        else:
            from .base import header_dtype
            r = c = np.zeros(0, np.int64)
            v = np.zeros(0, header_dtype(header))
        return r, c, v, shape, flat, split

    def _to_coo(self, groups: List[Dict[str, Any]]) -> SparseCOO:
        r, c, v, shape, flat, split = self._gather(groups)
        if self.transpose:
            r, c = c, r
        ndim = len(shape)
        rows_shape = shape[:split] or (1,)
        cols_shape = shape[split:] or (1,)
        idx = np.empty((len(v), ndim), dtype=np.int64)
        if split:
            for d, coord in enumerate(np.unravel_index(r, rows_shape)):
                idx[:, d] = coord
        if split < ndim:
            for d, coord in enumerate(np.unravel_index(c, cols_shape)):
                idx[:, split + d] = coord
        return SparseCOO(idx, v, shape)

    def decode(self, groups: List[Dict[str, Any]]) -> np.ndarray:
        """Decoded row groups -> the dense tensor."""
        return self._to_coo(groups).to_dense()

    def decode_coo(self, groups: List[Dict[str, Any]]) -> SparseCOO:
        """Decoded row groups -> :class:`SparseCOO` (no densify)."""
        return self._to_coo(groups)

    def slice_filters(self, header: Dict[str, Any], spec: SliceSpec):
        """Pushdown predicate selecting chunk rows for ``spec``."""
        if self.transpose:
            return {}  # CSC indexes by columns; leading-dim pushdown unavailable
        shape = header_shape(header)
        split = int(first_scalar(header["split"]))
        rows_shape = shape[:split] or (1,)
        los = [spec[d][0] for d in range(split)]
        his = [spec[d][1] - 1 for d in range(split)]
        if not los:
            return {}
        lo = int(np.ravel_multi_index(los, rows_shape))
        hi = int(np.ravel_multi_index(his, rows_shape))
        # chunk [row_start,row_end) overlaps [lo,hi] iff start<=hi and end>lo
        return {"row_start": (None, hi), "row_end": (lo + 1, None)}

    def decode_slice(self, groups: List[Dict[str, Any]], spec: SliceSpec) -> np.ndarray:
        """Decode only the ``spec`` window from pruned groups."""
        t = self._to_coo(groups)
        return t.slice(normalize_slices(t.shape, spec)).to_dense()


class CSCCodec(CSRCodec):
    """CSR's column-major sibling (encodes the transpose walk)."""

    layout = "csc"
    transpose = True


register(CSRCodec())
register(CSCCodec())
