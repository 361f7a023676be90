"""Shared codec machinery for the five paper formats.

A codec maps a tensor to/from *row groups*: a list of ``(columns, meta)``
pairs, where ``columns`` is a parq-lite column dict and ``meta`` tags the
group kind ("header" / "chunk"). The store persists each group as one or
more delta-table files so data skipping works at file granularity.

Slice specs follow the paper's Eq. (2): fix ranges on a prefix of the
dimensions, take everything in the rest. We normalize to a full-rank tuple
of ``(start, stop)`` pairs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import ml_dtypes  # noqa: F401 — registers bfloat16 et al. with numpy
except ImportError:  # a card host may have numpy without ml_dtypes
    ml_dtypes = None

SliceSpec = Tuple[Tuple[int, int], ...]

# Without ml_dtypes numpy has no bfloat16: such tensors stage as their raw
# 16-bit patterns, tagged so the device boundary
# (:func:`repro_torch.lake.device.to_torch`) views them as torch.bfloat16.
BF16_STAGING = np.dtype(np.uint16, metadata={"torch_dtype": "bfloat16"})


@dataclass
class SparseCOO:
    """COO carrier: what torch.sparse_coo_tensor is to the paper."""

    indices: np.ndarray  # (nnz, ndim) integer coordinates
    values: np.ndarray   # (nnz,)
    shape: Tuple[int, ...]

    @property
    def nnz(self) -> int:
        """Number of stored (non-zero) entries."""
        return len(self.values)

    @property
    def ndim(self) -> int:
        """Tensor rank."""
        return len(self.shape)

    @property
    def density(self) -> float:
        """nnz / total elements (0.0 for zero-size shapes)."""
        total = int(np.prod(self.shape))
        return self.nnz / total if total else 0.0

    @classmethod
    def from_dense(cls, x: np.ndarray) -> "SparseCOO":
        """Extract the non-zero pattern of a dense array."""
        idx = np.argwhere(x != 0)
        return cls(indices=idx.astype(np.int64),
                   values=x[tuple(idx.T)] if len(idx) else x.ravel()[:0],
                   shape=tuple(x.shape))

    def to_dense(self) -> np.ndarray:
        """Materialize the dense array (zeros where no entry)."""
        out = np.zeros(self.shape, dtype=self.values.dtype)
        if self.nnz:
            out[tuple(self.indices.T)] = self.values
        return out

    def sorted(self) -> "SparseCOO":
        """Entries re-ordered lexicographically, dim0 major."""
        if self.nnz == 0:
            return self
        order = np.lexsort(self.indices.T[::-1])  # dim0 major
        return SparseCOO(self.indices[order], self.values[order], self.shape)

    def slice(self, spec: SliceSpec) -> "SparseCOO":
        """Entries inside ``spec``, re-based to the slice's origin."""
        mask = np.ones(self.nnz, dtype=bool)
        for d, (lo, hi) in enumerate(spec):
            mask &= (self.indices[:, d] >= lo) & (self.indices[:, d] < hi)
        new_shape = tuple(hi - lo for lo, hi in spec)
        idx = self.indices[mask] - np.asarray([lo for lo, _ in spec], dtype=self.indices.dtype)
        return SparseCOO(idx, self.values[mask], new_shape)


def normalize_slices(shape: Sequence[int],
                     slices: Optional[Sequence[Optional[Tuple[int, int]]]]) -> SliceSpec:
    """Pad a leading-dims slice spec to full rank, clip to bounds."""
    shape = tuple(int(s) for s in shape)
    slices = list(slices or [])
    if len(slices) > len(shape):
        raise ValueError(f"slice rank {len(slices)} > tensor rank {len(shape)}")
    out: List[Tuple[int, int]] = []
    for d, dim in enumerate(shape):
        sl = slices[d] if d < len(slices) else None
        if sl is None:
            out.append((0, dim))
        else:
            lo, hi = sl
            lo = max(0, lo + dim if lo < 0 else lo)
            hi = min(dim, hi + dim if hi < 0 else hi)
            if hi < lo:
                hi = lo
            out.append((lo, hi))
    return tuple(out)


def slice_shape(spec: SliceSpec) -> Tuple[int, ...]:
    """Output shape of a normalized slice spec."""
    return tuple(hi - lo for lo, hi in spec)


@dataclass
class RowGroup:
    """One encoded unit a codec emits: a kind tag + parq-lite columns."""

    kind: str                 # "header" | "chunk"
    columns: Dict[str, Any]   # parq-lite column dict
    # numeric columns usable for file pruning on slice reads
    skip_columns: Tuple[str, ...] = ()


def dtype_name(dtype) -> str:
    """The dtype's name as headers record it: ``"bfloat16"`` for
    :data:`BF16_STAGING`, so that readers with ml_dtypes (the JAX package
    among them) read such a tensor back as bfloat16, not uint16."""
    dtype = np.dtype(dtype)
    return (dtype.metadata or {}).get("torch_dtype", str(dtype))


def make_header(shape: Sequence[int], dtype, **extra: Any) -> RowGroup:
    """Uniform 1-row header group each codec emits alongside its chunks.

    Tiny (one RTT to fetch), and it's what slice pushdown reads before any
    chunk file is touched. CSF extends it with fid0/fptr0/fid1/fptr1 per the
    paper's non-chunked data.
    """
    cols: Dict[str, Any] = {
        "__header__": np.asarray([1], dtype=np.int8),
        "dense_shape": [np.asarray(shape, dtype=np.int64)],
        "dtype": [dtype_name(dtype)],
    }
    for k, v in extra.items():
        if isinstance(v, np.ndarray):
            cols[k] = [v]
        elif isinstance(v, (list, tuple)):
            cols[k] = [np.asarray(v)]
        elif isinstance(v, str):
            cols[k] = [v]
        else:
            cols[k] = np.asarray([v])
    return RowGroup(kind="header", columns=cols)


def is_header(group: Dict[str, Any]) -> bool:
    """Whether a decoded row group is a tensor header."""
    return "__header__" in group


def split_groups(groups: List[Dict[str, Any]]):
    """(header, chunk_groups); raises ``ValueError`` with no header."""
    headers = [g for g in groups if is_header(g)]
    chunks = [g for g in groups if not is_header(g)]
    if not headers:
        raise ValueError("no header group present")
    return headers[0], chunks


def header_shape(header: Dict[str, Any]) -> Tuple[int, ...]:
    """Dense shape recorded in a header group."""
    return tuple(int(x) for x in header["dense_shape"][0])


def header_dtype(header: Dict[str, Any]) -> np.dtype:
    """Element dtype recorded in a header group (:data:`BF16_STAGING` for
    bfloat16 when ml_dtypes is absent)."""
    name = first_scalar(header["dtype"])
    if name == "bfloat16" and ml_dtypes is None:
        return BF16_STAGING
    return np.dtype(name)


class Codec:
    """Interface implemented by the five formats.

    Capability flags let callers (``TensorRef``) reject an unsupported
    operation before any chunk bytes are fetched, instead of failing deep
    inside decode:

    * ``supports_slice`` — the codec implements :meth:`decode_slice` (and
      usually :meth:`slice_filters` pushdown);
    * ``supports_coo`` — the codec decodes natively to :class:`SparseCOO`
      via ``decode_coo`` without materializing the dense tensor first.
    """

    layout: str = "?"
    supports_slice: bool = False
    supports_coo: bool = False

    def encode(self, tensor: Any, **params) -> List[RowGroup]:
        """Tensor -> row groups (header first, then chunk groups)."""
        raise NotImplementedError

    def decode(self, groups: List[Dict[str, Any]]) -> np.ndarray:
        """Decoded row groups -> the dense tensor."""
        raise NotImplementedError

    def slice_filters(self, header: Dict[str, Any], spec: SliceSpec) -> Dict[str, Tuple[int, int]]:
        """Pushdown predicate {column: (lo, hi)} selecting needed chunk rows."""
        return {}

    def decode_slice(self, groups: List[Dict[str, Any]], spec: SliceSpec) -> np.ndarray:
        """Decode only the ``spec`` window from (pruned) row groups."""
        raise NotImplementedError

    def decode_device(self, groups: List[Dict[str, Any]],
                      spec: Optional[SliceSpec] = None, *,
                      device: Any = "cuda"):
        """Decode onto a torch ``device``: ``(tensor, DeviceReadInfo)``.

        The base implementation is host decode followed by one copy to
        the device (:func:`repro_torch.lake.device.to_device`). FTSF and
        COO override this with device assembly that never materializes an
        ordered full host tensor.
        """
        from ...lake import device as lake_device
        arr = self.decode(groups) if spec is None else self.decode_slice(
            groups, spec)
        out = lake_device.to_device(arr, device)
        info = lake_device.DeviceReadInfo(
            path="host_fallback", host_staged_bytes=int(arr.nbytes),
            device_bytes=int(arr.nbytes), on_device=True)
        return out, info


def as_dense(tensor: Any) -> np.ndarray:
    """Coerce ndarray-or-SparseCOO to a dense ndarray."""
    return tensor.to_dense() if isinstance(tensor, SparseCOO) else np.asarray(tensor)


def as_coo(tensor: Any) -> SparseCOO:
    """Coerce ndarray-or-SparseCOO to :class:`SparseCOO`."""
    return tensor if isinstance(tensor, SparseCOO) else SparseCOO.from_dense(np.asarray(tensor))


def first_scalar(col: Any) -> Any:
    """First row of a column as a python scalar."""
    v = col[0]
    return v.item() if hasattr(v, "item") else v


_CODECS: Dict[str, Codec] = {}


def register(codec: Codec) -> Codec:
    """Register a layout codec under its ``layout`` name; returns it."""
    _CODECS[codec.layout] = codec
    return codec


def get_codec(layout: str) -> Codec:
    """The codec for ``layout``; raises ``KeyError`` listing known ones."""
    if layout not in _CODECS:
        raise KeyError(f"unknown layout {layout!r}; have {sorted(_CODECS)}")
    return _CODECS[layout]
