"""Device-side read assembly: staged host buffers -> torch tensors.

The last hop of the read pipeline (fetch -> staged decode -> **device**).
Codecs route decoded chunk payloads here instead of materializing a full
host tensor:

* :class:`ChunkAssembler` — a preallocated ``(n_slots, row_bytes)`` staging
  tensor (pinned when the target is a CUDA device) that chunk frames are
  written into via ``memoryview`` writes in **arrival order**; ``gather()``
  moves it to the device in one copy and reorders it there with the
  ``block_gather`` kernel. The only host copy is the staging write itself.
* :func:`scatter_coo` — COO decode straight to a dense device buffer via
  the ``coo_scatter`` kernel: indices and values are the only host arrays.
* :func:`to_torch` / :func:`to_device` — the numpy -> torch boundary. Torch
  holds every dtype the store writes exactly (f64, i64 and complex
  included), so nothing stays behind in numpy: bfloat16 crosses as an
  int16 view, unsigned 16/32/64-bit as same-width signed views.

Every entry point takes an explicit ``device`` (default ``"cuda"``). A CUDA
device runs the hand-written kernels, or raises when there is no card; the
CPU device runs their plain PyTorch versions. This module imports nothing
from ``repro_torch.core`` (the codecs in ``core/encodings`` call down into
it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..kernels import ops

# numpy dtypes that cross into torch through a same-width signed view
_VIEWED = {"bfloat16": (np.int16, torch.bfloat16),
           "uint16": (np.int16, torch.uint16),
           "uint32": (np.int32, torch.uint32),
           "uint64": (np.int64, torch.uint64)}


def resolve_device(device: Any) -> torch.device:
    """``device`` as a :class:`torch.device`; raises for a CUDA device on a
    host without one, and for device types the read path does not serve."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but "
                               f"torch.cuda.is_available() is false")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _viewed(dtype: np.dtype):
    """(numpy signed view, torch dtype) for dtypes crossing by view."""
    meta = dtype.metadata or {}
    return _VIEWED.get(meta.get("torch_dtype", dtype.name))


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype holding numpy ``dtype`` exactly; raises TypeError."""
    dtype = np.dtype(dtype)
    viewed = _viewed(dtype)
    if viewed is not None:
        return viewed[1]
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def to_torch(arr: np.ndarray, device: Any = "cuda") -> torch.Tensor:
    """numpy array -> torch tensor on ``device`` with the same bytes."""
    dev = resolve_device(device)
    arr = np.asarray(arr)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")  # torch.from_numpy wants writable
    viewed = _viewed(arr.dtype)
    if viewed is not None:
        host = torch.from_numpy(arr.view(viewed[0])).view(viewed[1])
    else:
        host = torch.from_numpy(arr)
    return host.to(dev)


def to_device(arr: np.ndarray, device: Any = "cuda") -> torch.Tensor:
    """One copy of a host array onto ``device`` (:func:`to_torch`)."""
    return to_torch(arr, device)


def is_device_array(x: Any, device: Any = "cuda") -> bool:
    """True when ``x`` is a torch tensor on a ``device``-type device."""
    return (isinstance(x, torch.Tensor)
            and x.device.type == torch.device(device).type)


@dataclass
class DeviceReadInfo:
    """Accounting for one device read, for stats and the zero-copy gate.

    ``path`` names how the tensor reached the device: ``"block_gather"``
    (chunk staging + device reorder), ``"coo_scatter"`` (sparse pairs
    scattered on device), or ``"host_fallback"`` (host decode then one
    transfer — layouts without a device kernel). ``host_staged_bytes`` is
    every byte the read materialized on the host en route — the
    zero-full-tensor-copy claim is ``host_staged_bytes`` not exceeding the
    payload actually read (never ordered-copy doubled, and for slice/sparse
    reads strictly less than the dense tensor).
    """

    path: str
    host_staged_bytes: int
    device_bytes: int
    on_device: bool


class ChunkAssembler:
    """Arrival-order chunk staging + on-device reorder.

    ``add(out_pos, blob)`` writes a chunk payload into the next free
    staging row via a ``memoryview`` write (chunks land in whatever order
    the pipeline delivers them); ``gather()`` copies the staging tensor to
    ``device`` once and permutes rows into output order with the
    ``block_gather`` kernel (one ``(1, row_elems)`` tile per row).
    """

    def __init__(self, n_slots: int, row_elems: int, dtype: Any,
                 device: Any = "cuda"):
        self.device = resolve_device(device)
        self.dtype = np.dtype(dtype)
        self.torch_dtype = torch_dtype(self.dtype)
        self.n_slots = int(n_slots)
        self.row_elems = max(1, int(row_elems))
        row_bytes = self.row_elems * self.dtype.itemsize
        self._staging = torch.empty((self.n_slots, row_bytes),
                                    dtype=torch.uint8,
                                    pin_memory=self.device.type == "cuda")
        self._rows = self._staging.numpy()
        # output position -> staging row, steering the gather
        self._ids = np.empty(self.n_slots, dtype=np.int32)
        self.count = 0

    @property
    def staged_bytes(self) -> int:
        """Host bytes written into the staging tensor so far."""
        return self.count * self._rows.shape[1]

    def add(self, out_pos: int, blob: Any) -> None:
        """Stage one chunk payload destined for output row ``out_pos``."""
        row = self.count
        self._rows[row] = np.frombuffer(blob, dtype=np.uint8)
        self._ids[out_pos] = row
        self.count += 1

    def gather(self) -> torch.Tensor:
        """The ``(n_slots, row_elems)`` tensor in output order on the
        device, after exactly one copy of the staging tensor."""
        if self.count != self.n_slots:
            raise ValueError(
                f"assembled {self.count} of {self.n_slots} chunks")
        rows = self._staging.to(self.device, non_blocking=True)
        rows = rows.view(self.torch_dtype)
        if self.n_slots == 0:
            return rows
        ids = torch.from_numpy(self._ids).to(self.device)
        tiles = ops.block_gather(rows, ids, (1, self.row_elems))
        return tiles.reshape(self.n_slots, self.row_elems)


def scatter_coo(flat_idx: np.ndarray, values: np.ndarray, size: int, *,
                device: Any = "cuda", unique: bool = False) -> torch.Tensor:
    """Dense flat ``(size,)`` tensor on ``device`` from COO pairs, via the
    ``coo_scatter`` kernel. Indices are int64, so any size goes."""
    idx = to_torch(np.asarray(flat_idx, dtype=np.int64).reshape(-1), device)
    return ops.coo_scatter(idx, to_torch(values, device), int(size),
                           unique=unique)
