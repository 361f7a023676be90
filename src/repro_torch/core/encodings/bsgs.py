"""BSGS — Block Sparse Generic Storage (paper §IV.F).

Mode-Generic/BCSR generalized: partition the tensor on a block grid, keep
only non-zero blocks as (block coordinates, flattened dense block). One
table row per non-zero block; per-dimension block-coordinate columns give
min/max stats for slice pruning ("partitioning before encoding" — the slice
can be served without decoding the whole tensor). Metadata columns
(dense_shape, block_shape, dtype) repeat per row and collapse under
columnar dictionary/RLE encoding, the paper's Fig. 9 "value, 4" notation.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from .base import (Codec, RowGroup, SliceSpec, SparseCOO, as_coo,
                   header_shape, make_header, normalize_slices, register,
                   slice_shape, split_groups)


def _norm_block_shape(shape: Tuple[int, ...], block_shape) -> Tuple[int, ...]:
    if block_shape is None:
        # heuristic default: cover trailing dims up to ~512 elements
        bs = [1] * len(shape)
        prod = 1
        for d in range(len(shape) - 1, -1, -1):
            take = min(shape[d], max(1, 512 // prod))
            bs[d] = take
            prod *= take
            if prod >= 512:
                break
        return tuple(bs)
    block_shape = tuple(int(b) for b in block_shape)
    if len(block_shape) < len(shape):  # pad leading 1s (paper's 1x2 on a 3x4x2)
        block_shape = (1,) * (len(shape) - len(block_shape)) + block_shape
    if len(block_shape) != len(shape):
        raise ValueError(f"block shape {block_shape} vs tensor rank {len(shape)}")
    return tuple(min(b, s) for b, s in zip(block_shape, shape))


class BSGSCodec(Codec):
    """Block-Sparse Grid Storage (paper §IV.E)."""

    layout = "bsgs"
    supports_slice = True
    supports_coo = False      # decode_coo here is a dense round-trip, not native

    def encode(self, tensor: Any, *, block_shape=None, **_) -> List[RowGroup]:
        """Tensor -> row groups (header + chunk rows)."""
        t = as_coo(tensor)
        shape = t.shape
        bs = _norm_block_shape(shape, block_shape)
        grid = tuple(-(-s // b) for s, b in zip(shape, bs))
        block_elems = int(np.prod(bs))
        ndim = t.ndim

        if t.nnz:
            bidx = t.indices // np.asarray(bs, dtype=t.indices.dtype)
            off = t.indices % np.asarray(bs, dtype=t.indices.dtype)
            bkey = np.ravel_multi_index([bidx[:, d] for d in range(ndim)], grid)
            okey = np.ravel_multi_index([off[:, d] for d in range(ndim)], bs)
            order = np.argsort(bkey, kind="stable")
            bkey, okey, vals = bkey[order], okey[order], t.values[order]
            ukeys, inverse = np.unique(bkey, return_inverse=True)
            buf = np.zeros((len(ukeys), block_elems), dtype=t.values.dtype)
            buf[inverse, okey] = vals
            ucoords = np.stack(np.unravel_index(ukeys, grid), axis=1)
        else:
            ukeys = np.zeros(0, np.int64)
            buf = np.zeros((0, block_elems), dtype=t.values.dtype)
            ucoords = np.zeros((0, ndim), np.int64)

        n_blocks = len(ukeys)
        cols: Dict[str, Any] = {
            "block_key": ukeys.astype(np.int64) if n_blocks else np.asarray([-1], np.int64),
            "values": (list(buf) if n_blocks
                       else [np.zeros(0, t.values.dtype)]),
            "dense_shape": [np.asarray(shape, np.int64)] * max(n_blocks, 1),
            "block_shape": [np.asarray(bs, np.int64)] * max(n_blocks, 1),
            "dtype": [str(t.values.dtype)] * max(n_blocks, 1),
        }
        for d in range(ndim):
            cols[f"bidx{d}"] = (ucoords[:, d].astype(np.int64)
                                if n_blocks else np.zeros(1, np.int64))
        skip = tuple(f"bidx{d}" for d in range(ndim))
        header = make_header(shape, t.values.dtype,
                             block_shape=np.asarray(bs, np.int64))
        return [header, RowGroup(kind="chunk", columns=cols, skip_columns=skip)]

    # -- decode -----------------------------------------------------------------

    @staticmethod
    def _meta(groups: List[Dict[str, Any]]):
        header, chunks = split_groups(groups)
        from .base import header_dtype
        shape = header_shape(header)
        bs = tuple(int(x) for x in header["block_shape"][0])
        return shape, bs, header_dtype(header), chunks

    def _scatter(self, groups: List[Dict[str, Any]], region: SliceSpec) -> np.ndarray:
        """Scatter blocks intersecting ``region`` into a padded buffer, crop.

        Vectorized: one row-scatter into a (n_env_blocks, block_elems)
        matrix, then a transpose back to the interleaved dense layout.
        """
        shape, bs, dtype, groups = self._meta(groups)
        ndim = len(shape)
        block_elems = int(np.prod(bs))
        # block-aligned envelope of the region
        blo = np.asarray([region[d][0] // bs[d] for d in range(ndim)])
        bhi = np.asarray([max(blo[d] + 1, -(-region[d][1] // bs[d]))
                          for d in range(ndim)])
        env_blocks = tuple(int(x) for x in (bhi - blo))
        n_env = int(np.prod(env_blocks))

        kept = []   # (coords, flat values) across batches
        for g in groups:
            keys = np.asarray(g["block_key"])
            coords = np.stack([np.asarray(g[f"bidx{d}"]) for d in range(ndim)],
                              axis=1)
            keep = (keys >= 0) & np.all((coords >= blo) & (coords < bhi), axis=1)
            for i in np.flatnonzero(keep):
                kept.append((coords[i], g["values"][i]))

        out_shape = tuple(region[d][1] - region[d][0] for d in range(ndim))
        if len(kept) < 4096 or len(kept) * block_elems > 4 * n_env:
            # few/large blocks (time-major layouts): place each block
            # directly — no padded intermediate, no giant transpose
            out = np.zeros(out_shape, dtype=dtype)
            r0 = [region[d][0] for d in range(ndim)]
            for c, v in kept:
                block = np.asarray(v).reshape(bs).astype(dtype, copy=False)
                src, dst = [], []
                ok = True
                for d in range(ndim):
                    lo_abs = int(c[d]) * bs[d]
                    a = max(lo_abs, region[d][0])
                    z = min(lo_abs + bs[d], region[d][1])
                    if z <= a:
                        ok = False
                        break
                    src.append(slice(a - lo_abs, z - lo_abs))
                    dst.append(slice(a - r0[d], z - r0[d]))
                if ok:
                    out[tuple(dst)] = block[tuple(src)]
            return out

        # many small blocks: one vectorized row scatter + layout transpose
        buf2 = np.zeros((n_env, block_elems), dtype=dtype)
        if kept:
            coords = np.stack([c for c, _ in kept])
            rows = np.ravel_multi_index((coords - blo).T, env_blocks)
            stacked = np.concatenate(
                [np.asarray(v).reshape(-1) for _, v in kept]).reshape(
                len(kept), block_elems)
            buf2[rows] = stacked.astype(dtype, copy=False)
        full = buf2.reshape(tuple(env_blocks) + tuple(bs))
        perm = [x for d in range(ndim) for x in (d, ndim + d)]
        buf = full.transpose(perm).reshape(
            tuple(env_blocks[d] * bs[d] for d in range(ndim)))
        crop = tuple(slice(region[d][0] - int(blo[d]) * bs[d],
                           region[d][1] - int(blo[d]) * bs[d])
                     for d in range(ndim))
        return buf[crop]

    def decode(self, groups: List[Dict[str, Any]]) -> np.ndarray:
        """Decoded row groups -> the dense tensor."""
        shape, _, _, _ = self._meta(groups)
        return self._scatter(groups, tuple((0, s) for s in shape))

    def decode_coo(self, groups: List[Dict[str, Any]]) -> SparseCOO:
        """Decoded row groups -> :class:`SparseCOO` (no densify)."""
        return SparseCOO.from_dense(self.decode(groups))

    def slice_filters(self, header: Dict[str, Any], spec: SliceSpec):
        """Pushdown predicate selecting chunk rows for ``spec``."""
        shape = header_shape(header)
        bs = tuple(int(x) for x in header["block_shape"][0])
        out = {}
        for d, (lo, hi) in enumerate(spec):
            if (lo, hi) != (0, shape[d]):
                out[f"bidx{d}"] = (lo // bs[d], (hi - 1) // bs[d])
        return out

    def decode_slice(self, groups: List[Dict[str, Any]], spec: SliceSpec) -> np.ndarray:
        """Decode only the ``spec`` window from pruned groups."""
        shape, _, _, _ = self._meta(groups)
        spec = normalize_slices(shape, spec)
        out = self._scatter(groups, spec)
        assert out.shape == slice_shape(spec)
        return out


register(BSGSCodec())
