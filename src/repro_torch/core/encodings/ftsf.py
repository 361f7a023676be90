"""FTSF — Flattened Tensor Storage Format (paper §IV.A).

A rank-N tensor is split along its leading ``N - Dc`` dimensions into
rank-``Dc`` chunks; each chunk becomes one table row
``(chunk_index, chunk BINARY)`` plus the paper's metadata columns
(``dim_count``, ``dimensions``, ``chunk_dim_count``), which dictionary/RLE
encoding makes nearly free. ``chunk_index`` is the row-major flattening of
the leading indices, so a slice on the leading dims maps to a
``chunk_index`` interval and the delta log's min/max stats skip every file
outside it — that is the paper's −90 % read-slice result.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from .base import (Codec, RowGroup, SliceSpec, as_dense, dtype_name,
                   first_scalar, header_dtype, header_shape, make_header,
                   normalize_slices, register, slice_shape, split_groups)


class FTSFCodec(Codec):
    """Flattened Tensor Storage Format (paper §IV.A)."""

    layout = "ftsf"
    supports_slice = True
    supports_coo = False      # dense chunks: COO reads densify first

    def encode(self, tensor: Any, *, chunk_dims: int = None, **_) -> List[RowGroup]:
        """Tensor -> row groups (header + chunk rows)."""
        x = as_dense(tensor)
        n = x.ndim
        if chunk_dims is None:
            chunk_dims = max(n - 1, 0)
        if not 0 <= chunk_dims <= n:
            raise ValueError(f"chunk_dims {chunk_dims} out of range for rank {n}")
        lead = x.shape[: n - chunk_dims]
        n_chunks = int(np.prod(lead)) if lead else 1
        flat = np.ascontiguousarray(x).reshape(n_chunks, -1)
        chunk_nbytes = flat[0].nbytes if n_chunks else 0
        cols: Dict[str, Any] = {
            "chunk_index": np.arange(n_chunks, dtype=np.int64),
            "chunk": [flat[i].tobytes() for i in range(n_chunks)],
            "dim_count": np.full(n_chunks, n, dtype=np.int32),
            "dimensions": [np.asarray(x.shape, dtype=np.int64)] * n_chunks,
            "chunk_dim_count": np.full(n_chunks, chunk_dims, dtype=np.int32),
            "dtype": [dtype_name(x.dtype)] * n_chunks,
        }
        del chunk_nbytes
        header = make_header(x.shape, x.dtype, chunk_dim_count=chunk_dims,
                             dimensions=np.asarray(x.shape, dtype=np.int64))
        return [header,
                RowGroup(kind="chunk", columns=cols, skip_columns=("chunk_index",))]

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _meta(groups: List[Dict[str, Any]]) -> Tuple[Tuple[int, ...], int, np.dtype, List[Dict[str, Any]]]:
        header, chunks = split_groups(groups)
        shape = header_shape(header)
        chunk_dims = int(first_scalar(header["chunk_dim_count"]))
        return shape, chunk_dims, header_dtype(header), chunks

    def decode(self, groups: List[Dict[str, Any]]) -> np.ndarray:
        """Decoded row groups -> the dense tensor."""
        shape, chunk_dims, dtype, groups = self._meta(groups)
        lead = shape[: len(shape) - chunk_dims]
        n_chunks = int(np.prod(lead)) if lead else 1
        chunk_elems = int(np.prod(shape[len(shape) - chunk_dims:])) if chunk_dims else 1
        out = np.empty((n_chunks, chunk_elems), dtype=dtype)
        seen = 0
        for g in groups:
            for i, blob in zip(np.asarray(g["chunk_index"]), g["chunk"]):
                out[int(i)] = np.frombuffer(blob, dtype=dtype)
                seen += 1
        if seen != n_chunks:
            raise ValueError(f"decode: got {seen}/{n_chunks} chunks")
        return out.reshape(shape)

    def slice_filters(self, header: Dict[str, Any], spec: SliceSpec):
        """Pushdown predicate selecting chunk rows for ``spec``."""
        shape = header_shape(header)
        chunk_dims = int(first_scalar(header["chunk_dim_count"]))
        lead = shape[: len(shape) - chunk_dims]
        if not lead:
            return {}
        # envelope of row-major flattened leading indices
        los = [spec[d][0] for d in range(len(lead))]
        his = [spec[d][1] - 1 for d in range(len(lead))]
        lo = int(np.ravel_multi_index(los, lead))
        hi = int(np.ravel_multi_index(his, lead))
        return {"chunk_index": (lo, hi)}

    def decode_slice(self, groups: List[Dict[str, Any]], spec: SliceSpec) -> np.ndarray:
        """Decode only the ``spec`` window from pruned groups."""
        shape, chunk_dims, dtype, groups = self._meta(groups)
        spec = normalize_slices(shape, spec)
        n = len(shape)
        lead = shape[: n - chunk_dims]
        if chunk_dims and any(spec[d] != (0, shape[d]) for d in range(n - chunk_dims, n)):
            # sub-chunk slicing: fetch covering chunks, crop locally
            pass
        n_lead = len(lead)
        lead_spec = spec[:n_lead]
        out_lead = slice_shape(lead_spec)
        chunk_shape = shape[n - chunk_dims:]
        out = np.empty(tuple(out_lead) + tuple(chunk_shape), dtype=dtype)
        out2d = out.reshape(int(np.prod(out_lead)) if out_lead else 1, -1)
        wanted: Dict[int, int] = {}
        if n_lead:
            grids = np.meshgrid(*[np.arange(lo, hi) for lo, hi in lead_spec], indexing="ij")
            flat_idx = np.ravel_multi_index([g.ravel() for g in grids], lead)
            wanted = {int(ci): pos for pos, ci in enumerate(flat_idx)}
        else:
            wanted = {0: 0}
        found = 0
        for g in groups:
            for i, blob in zip(np.asarray(g["chunk_index"]), g["chunk"]):
                pos = wanted.get(int(i))
                if pos is None:
                    continue
                out2d[pos] = np.frombuffer(blob, dtype=dtype)
                found += 1
        if found != len(wanted):
            raise ValueError(f"decode_slice: got {found}/{len(wanted)} chunks")
        # crop trailing (in-chunk) dims if the slice narrows them
        trailing = tuple(slice(lo, hi) for lo, hi in spec[n_lead:])
        return out[(Ellipsis,) + trailing] if trailing else out

    def decode_device(self, groups: List[Dict[str, Any]],
                      spec: SliceSpec = None, *, device: Any = "cuda"):
        """Chunk rows -> tensor on ``device`` without an ordered host copy.

        Chunk payloads are staged into a preallocated buffer in **arrival
        order** (one memoryview write per chunk — the only host copy),
        then the whole buffer moves to the device once and the
        ``block_gather`` kernel permutes rows into ``chunk_index`` order
        there. Sub-chunk (trailing-dim) crops happen on the device view.
        """
        from ...lake import device as lake_device
        shape, chunk_dims, dtype, groups = self._meta(groups)
        n = len(shape)
        spec = normalize_slices(shape, spec)
        lead = shape[: n - chunk_dims]
        n_lead = len(lead)
        lead_spec = spec[:n_lead]
        out_lead = slice_shape(lead_spec)
        chunk_shape = shape[n - chunk_dims:]
        chunk_elems = int(np.prod(chunk_shape)) if chunk_dims else 1
        wanted: Dict[int, int] = {0: 0}
        if n_lead:
            grids = np.meshgrid(*[np.arange(lo, hi) for lo, hi in lead_spec],
                                indexing="ij")
            flat_idx = np.ravel_multi_index([g.ravel() for g in grids], lead)
            wanted = {int(ci): pos for pos, ci in enumerate(flat_idx)}
        asm = lake_device.ChunkAssembler(len(wanted), chunk_elems, dtype,
                                         device=device)
        for g in groups:
            for i, blob in zip(np.asarray(g["chunk_index"]), g["chunk"]):
                pos = wanted.get(int(i))
                if pos is not None:
                    asm.add(pos, blob)
        if asm.count != len(wanted):
            raise ValueError(
                f"decode_device: got {asm.count}/{len(wanted)} chunks")
        rows = asm.gather()
        out = rows.reshape(tuple(out_lead) + tuple(chunk_shape))
        trailing = tuple(slice(lo, hi) for lo, hi in spec[n_lead:])
        if any(sp != (0, d) for sp, d in zip(spec[n_lead:], chunk_shape)):
            out = out[(Ellipsis,) + trailing]
        info = lake_device.DeviceReadInfo(
            path="block_gather", host_staged_bytes=asm.staged_bytes,
            device_bytes=int(np.prod(out.shape)) * np.dtype(dtype).itemsize,
            on_device=True)
        return out, info


register(FTSFCodec())
