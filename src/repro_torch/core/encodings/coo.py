"""COO — Coordinate encoding (paper §IV.C).

One logical row per non-zero: coordinates + value + (id, layout,
dense_shape) metadata. Deviation from the paper's Fig. 5, recorded in
DESIGN.md: instead of a single ``indices ARRAY<INT>`` column we emit one
integer column per dimension (``idx0``, ``idx1``, ...). The information is
identical, but per-dimension columns give the delta log min/max stats on
*every* coordinate, so slice reads prune files on any leading-dim range —
strictly better data skipping at zero cost (Parquet/parq-lite dictionary
encoding was already columnar).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from .base import (Codec, RowGroup, SliceSpec, SparseCOO, as_coo,
                   header_dtype, header_shape, make_header, normalize_slices,
                   register, split_groups)


class COOCodec(Codec):
    """Per-element COO rows (paper's sparse baseline)."""

    layout = "coo"
    supports_slice = True
    supports_coo = True

    def encode(self, tensor: Any, **_) -> List[RowGroup]:
        """Tensor -> row groups (header + chunk rows)."""
        t = as_coo(tensor).sorted()
        cols: Dict[str, Any] = {
            "nnz_index": np.arange(t.nnz, dtype=np.int64),
            "value": np.asarray(t.values),
            "dense_shape": [np.asarray(t.shape, dtype=np.int64)] * t.nnz,
        }
        for d in range(t.ndim):
            cols[f"idx{d}"] = t.indices[:, d].astype(np.int64)
        if t.nnz == 0:  # keep schema discoverable for empty tensors
            cols["dense_shape"] = [np.asarray(t.shape, dtype=np.int64)]
            cols["nnz_index"] = np.asarray([-1], dtype=np.int64)
            cols["value"] = np.zeros(1, dtype=t.values.dtype)
            for d in range(t.ndim):
                cols[f"idx{d}"] = np.zeros(1, dtype=np.int64)
        skip = tuple(f"idx{d}" for d in range(t.ndim))
        header = make_header(t.shape, t.values.dtype, layout="COO")
        return [header, RowGroup(kind="chunk", columns=cols, skip_columns=skip)]

    @staticmethod
    def _coo(groups: List[Dict[str, Any]]) -> SparseCOO:
        header, groups = split_groups(groups)
        shape = header_shape(header)
        ndim = len(shape)
        idx_parts, val_parts = [], []
        for g in groups:
            keep = np.asarray(g["nnz_index"]) >= 0
            if not keep.any():
                continue
            idx = np.stack([np.asarray(g[f"idx{d}"])[keep] for d in range(ndim)], axis=1)
            idx_parts.append(idx)
            val_parts.append(np.asarray(g["value"])[keep])
        if not idx_parts:
            return SparseCOO(np.zeros((0, ndim), np.int64),
                             np.zeros(0, header_dtype(header)), shape)
        return SparseCOO(np.concatenate(idx_parts), np.concatenate(val_parts), shape)

    def decode(self, groups: List[Dict[str, Any]]) -> np.ndarray:
        """Decoded row groups -> the dense tensor."""
        return self._coo(groups).to_dense()

    def decode_coo(self, groups: List[Dict[str, Any]]) -> SparseCOO:
        """Decoded row groups -> :class:`SparseCOO` (no densify)."""
        return self._coo(groups)

    def slice_filters(self, header: Dict[str, Any], spec: SliceSpec):
        """Pushdown predicate selecting chunk rows for ``spec``."""
        shape = header_shape(header)
        out = {}
        for d, (lo, hi) in enumerate(spec):
            if (lo, hi) != (0, shape[d]):
                out[f"idx{d}"] = (lo, hi - 1)
        return out

    def decode_slice(self, groups: List[Dict[str, Any]], spec: SliceSpec) -> np.ndarray:
        """Decode only the ``spec`` window from pruned groups."""
        t = self._coo(groups)
        return t.slice(normalize_slices(t.shape, spec)).to_dense()

    def decode_device(self, groups: List[Dict[str, Any]],
                      spec: SliceSpec = None, *, device: Any = "cuda"):
        """COO rows -> dense tensor on ``device``; the dense array never
        exists on the host. Only the (nnz, ndim) indices and (nnz,) values
        are staged; the ``coo_scatter`` kernel materializes the
        zeros-filled dense buffer directly on the device. Stored
        coordinates are unique, so the scatter stores instead of adding.
        """
        from ...lake import device as lake_device
        t = self._coo(groups)
        if spec is not None:
            t = t.slice(normalize_slices(t.shape, spec))
        size = int(np.prod(t.shape)) if t.ndim else 1
        if t.nnz and t.ndim:
            flat = np.ravel_multi_index(tuple(t.indices.T), t.shape)
        else:
            flat = np.zeros(0, dtype=np.int64)
        values = np.asarray(t.values)
        out = lake_device.scatter_coo(flat, values, size, device=device,
                                      unique=True)
        out = out.reshape(t.shape)
        info = lake_device.DeviceReadInfo(
            path="coo_scatter",
            host_staged_bytes=int(t.indices.nbytes + values.nbytes),
            device_bytes=size * values.dtype.itemsize, on_device=True)
        return out, info


register(COOCodec())
