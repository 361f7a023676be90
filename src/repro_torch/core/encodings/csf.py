"""CSF — Compressed Sparse Fiber (paper §IV.E).

The sorted non-zeros form a prefix tree: level *l* nodes are the unique
length-(l+1) coordinate prefixes. Per level we keep ``fid`` (the level-l
coordinate of each node) and ``fptr`` (offsets into level-(l+1) nodes).
Following the paper's storage layout, the first two levels are stored once
per tensor ("non-chunked": ``fid0/fptr0/fid1/fptr1``) and everything deeper
— plus the values — is chunked along level-1 fiber boundaries, each chunk
annotated with its level-1 node range ``[n1_start, n1_end)`` so a slice on
the leading dimension walks ``fid0``/``fptr0`` and fetches only overlapping
chunks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from .base import (Codec, RowGroup, SliceSpec, SparseCOO, as_coo, header_dtype,
                   header_shape, is_header, normalize_slices, register)

TARGET_LEAVES_PER_CHUNK = 1 << 16


def _dedupe(t: SparseCOO) -> SparseCOO:
    """Sort lexicographically and sum duplicate coordinates."""
    t = t.sorted()
    if t.nnz == 0:
        return t
    same = np.all(t.indices[1:] == t.indices[:-1], axis=1)
    if not same.any():
        return t
    starts = np.flatnonzero(np.concatenate(([True], ~same)))
    seg = np.repeat(np.arange(len(starts)), np.diff(np.concatenate((starts, [t.nnz]))))
    vals = np.bincount(seg, weights=t.values.astype(np.float64)).astype(t.values.dtype)
    return SparseCOO(t.indices[starts], vals, t.shape)


def _build_tree(idx: np.ndarray, nnz: int, ndim: int):
    """node_starts[l]: nnz-positions where a new level-l node begins."""
    node_starts: List[np.ndarray] = []
    prev = None
    for l in range(ndim):
        ch = np.concatenate(([True], idx[1:, l] != idx[:-1, l])) if nnz else np.zeros(0, bool)
        if prev is not None:
            ch = ch | prev
        node_starts.append(np.flatnonzero(ch))
        prev = ch
    return node_starts


class CSFCodec(Codec):
    """Compressed Sparse Fiber trees (paper §IV.D)."""

    layout = "csf"
    supports_slice = True
    supports_coo = True

    def encode(self, tensor: Any, **_) -> List[RowGroup]:
        """Tensor -> row groups (header + chunk rows)."""
        t = _dedupe(as_coo(tensor))
        idx, vals, ndim, nnz = t.indices, t.values, t.ndim, t.nnz
        node_starts = _build_tree(idx, nnz, ndim)
        fids = [idx[node_starts[l], l].astype(np.int64) for l in range(ndim)]
        fptrs: List[np.ndarray] = []
        for l in range(ndim - 1):
            p = np.searchsorted(node_starts[l + 1], node_starts[l]).astype(np.int64)
            fptrs.append(np.concatenate((p, [len(node_starts[l + 1])])))

        hl = min(2, ndim)                     # header levels (paper: first two)
        unit = hl - 1                         # chunking level
        n_unit = len(node_starts[unit]) if nnz else 0

        header: Dict[str, Any] = {
            "__header__": np.asarray([1], dtype=np.int8),
            "dense_shape": [np.asarray(t.shape, dtype=np.int64)],
            "nnz": np.asarray([nnz], dtype=np.int64),
            "dtype": [str(vals.dtype)],
            "fid0": [fids[0] if nnz else np.zeros(0, np.int64)],
        }
        if ndim >= 2:
            header["fptr0"] = [fptrs[0] if nnz else np.zeros(1, np.int64)]
            header["fid1"] = [fids[1] if nnz else np.zeros(0, np.int64)]
        if ndim >= 3:
            header["fptr1"] = [fptrs[1] if nnz else np.zeros(1, np.int64)]
        groups = [RowGroup(kind="header", columns=header)]

        if nnz == 0:
            return groups

        # leaves spanned by each chunking-level node
        unit_starts = node_starts[unit]
        unit_leaf_bounds = np.concatenate((unit_starts, [nnz]))
        # greedy split: consecutive unit nodes until ~TARGET leaves
        cut_ids = [0]
        while cut_ids[-1] < n_unit:
            target = unit_leaf_bounds[cut_ids[-1]] + TARGET_LEAVES_PER_CHUNK
            nxt = int(np.searchsorted(unit_leaf_bounds, target, side="left"))
            cut_ids.append(max(min(nxt, n_unit), cut_ids[-1] + 1))

        cols: Dict[str, Any] = {k: [] for k in
                                ("n1_start", "n1_end", "leaf_start", "values")}
        deep_levels = list(range(2, ndim))
        for l in deep_levels:
            cols[f"fid{l}"] = []
            if l < ndim - 1:
                cols[f"fptr{l}"] = []
        for a, b in zip(cut_ids[:-1], cut_ids[1:]):
            leaf_s, leaf_e = int(unit_leaf_bounds[a]), int(unit_leaf_bounds[b])
            cols["n1_start"].append(a)
            cols["n1_end"].append(b)
            cols["leaf_start"].append(leaf_s)
            cols["values"].append(vals[leaf_s:leaf_e])
            # global node range per deeper level, by composing fptrs
            gs, ge = a, b
            for l in deep_levels:
                gs, ge = int(fptrs[l - 1][gs]), int(fptrs[l - 1][ge])
                cols[f"fid{l}"].append(fids[l][gs:ge])
                if l < ndim - 1:
                    loc = fptrs[l][gs:ge + 1]
                    cols[f"fptr{l}"].append(loc - loc[0])
        n_chunks = len(cols["n1_start"])
        chunk_cols: Dict[str, Any] = {
            "n1_start": np.asarray(cols["n1_start"], dtype=np.int64),
            "n1_end": np.asarray(cols["n1_end"], dtype=np.int64),
            "leaf_start": np.asarray(cols["leaf_start"], dtype=np.int64),
            "values": cols["values"],
        }
        for l in deep_levels:
            chunk_cols[f"fid{l}"] = cols[f"fid{l}"]
            if l < ndim - 1:
                chunk_cols[f"fptr{l}"] = cols[f"fptr{l}"]
        del n_chunks
        groups.append(RowGroup(kind="chunk", columns=chunk_cols,
                               skip_columns=("n1_start", "n1_end")))
        return groups

    # -- decode -----------------------------------------------------------------

    @staticmethod
    def _split(groups: List[Dict[str, Any]]):
        header = next(g for g in groups if is_header(g))
        chunks = [g for g in groups if not is_header(g)]
        return header, chunks

    def _chunk_coo(self, header: Dict[str, Any], g: Dict[str, Any], i: int,
                   ndim: int) -> Tuple[np.ndarray, np.ndarray]:
        """Rebuild (coords, values) for chunk row i of batch g."""
        s = int(np.asarray(g["n1_start"])[i])
        e = int(np.asarray(g["n1_end"])[i])
        vals = np.asarray(g["values"][i])
        L = len(vals)
        coords = np.empty((L, ndim), dtype=np.int64)
        fid0 = np.asarray(header["fid0"][0])
        if ndim == 1:
            coords[:, 0] = fid0[s:e]
            return coords, vals
        fptr0 = np.asarray(header["fptr0"][0])
        fid1 = np.asarray(header["fid1"][0])
        if ndim == 2:
            lc1 = np.ones(e - s, dtype=np.int64)  # level-1 nodes are leaves
        else:
            # bottom-up: fill deep coords and propagate per-node leaf counts
            deepest = np.asarray(g[f"fid{ndim - 1}"][i])
            coords[:, ndim - 1] = deepest
            lc_prev = np.ones(len(deepest), dtype=np.int64)
            for l in range(ndim - 2, 1, -1):
                fptr_l = np.asarray(g[f"fptr{l}"][i])
                cum = np.concatenate(([0], np.cumsum(lc_prev)))
                lc_l = cum[fptr_l[1:]] - cum[fptr_l[:-1]]
                coords[:, l] = np.repeat(np.asarray(g[f"fid{l}"][i]), lc_l)
                lc_prev = lc_l
            # lc_prev now holds leaf counts per local level-2 node
            fptr1 = np.asarray(header["fptr1"][0])
            ch1 = fptr1[s:e + 1] - fptr1[s]
            cum = np.concatenate(([0], np.cumsum(lc_prev)))
            lc1 = cum[ch1[1:]] - cum[ch1[:-1]]
        coords[:, 1] = np.repeat(fid1[s:e], lc1)
        i0 = np.searchsorted(fptr0, np.arange(s, e), side="right") - 1
        coords[:, 0] = np.repeat(fid0[i0], lc1)
        return coords, vals

    def _to_coo(self, groups: List[Dict[str, Any]]) -> SparseCOO:
        header, chunks = self._split(groups)
        shape = header_shape(header)
        dtype = header_dtype(header)
        ndim = len(shape)
        all_coords, all_vals = [], []
        for g in chunks:
            for i in range(len(np.asarray(g["n1_start"]))):
                c, v = self._chunk_coo(header, g, i, ndim)
                all_coords.append(c)
                all_vals.append(v)
        if not all_coords:
            return SparseCOO(np.zeros((0, ndim), np.int64), np.zeros(0, dtype), shape)
        return SparseCOO(np.concatenate(all_coords),
                         np.concatenate(all_vals).astype(dtype), shape)

    def decode(self, groups: List[Dict[str, Any]]) -> np.ndarray:
        """Decoded row groups -> the dense tensor."""
        return self._to_coo(groups).to_dense()

    def decode_coo(self, groups: List[Dict[str, Any]]) -> SparseCOO:
        """Decoded row groups -> :class:`SparseCOO` (no densify)."""
        return self._to_coo(groups)

    def slice_filters(self, header: Dict[str, Any], spec: SliceSpec):
        """Pushdown predicate selecting chunk rows for ``spec``."""
        shape = header_shape(header)
        lo, hi = spec[0]
        if (lo, hi) == (0, shape[0]) or len(shape) < 2:
            return {}
        fid0 = np.asarray(header["fid0"][0])
        fptr0 = np.asarray(header["fptr0"][0])
        p0s = int(np.searchsorted(fid0, lo, side="left"))
        p0e = int(np.searchsorted(fid0, hi - 1, side="right"))
        if p0s >= p0e:
            return {"n1_start": (0, -1)}  # empty: prunes everything
        n1s, n1e = int(fptr0[p0s]), int(fptr0[p0e])
        return {"n1_start": (None, n1e - 1), "n1_end": (n1s + 1, None)}

    def decode_slice(self, groups: List[Dict[str, Any]], spec: SliceSpec) -> np.ndarray:
        """Decode only the ``spec`` window from pruned groups."""
        t = self._to_coo(groups)
        return t.slice(normalize_slices(t.shape, spec)).to_dense()


register(CSFCodec())
