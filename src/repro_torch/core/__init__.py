"""The paper's primary contribution: tensor storage in a delta table.

Five codecs (FTSF, COO, CSR/CSC, CSF, BSGS), the 10% sparsity policy, the
DeltaTensorStore facade with its handle API (Catalog / TensorRef /
WriteBatch), and device-side (jit) encodings for in-training use.
"""
from .encodings.base import Codec, SparseCOO, get_codec, normalize_slices
from .encodings import ftsf, coo, csr, csf, bsgs  # noqa: F401 (register codecs)
from .sparsity import SPARSE_THRESHOLD, choose_layout, density
from .cas import ChunkEntry, ChunkIndex, chunk_hash, chunk_index_for
from .catalog import (Catalog, ShardSource, TensorEntry, TensorRef,
                      build_catalog_index)
from .batch import BatchClosedError, WriteBatch
from .leases import Lease, LeaseRegistry, RetentionPolicy, registry_for
from .sharding import ShardRouter, VersionVector, load_manifest
from .store import DeltaTensorStore

__all__ = ["Codec", "SparseCOO", "get_codec", "normalize_slices",
           "SPARSE_THRESHOLD", "choose_layout", "density", "DeltaTensorStore",
           "Catalog", "TensorEntry", "TensorRef", "WriteBatch",
           "BatchClosedError", "ShardRouter", "VersionVector",
           "load_manifest", "Lease", "LeaseRegistry", "RetentionPolicy",
           "registry_for", "ShardSource", "build_catalog_index",
           "ChunkEntry", "ChunkIndex", "chunk_hash", "chunk_index_for"]
