from .object_store import (FaultInjectingObjectStore, FaultRule,
                           InjectedFault, InMemoryObjectStore, LatencyModel,
                           LocalFSObjectStore, ObjectNotFoundError,
                           ObjectStore, PutIfAbsentError)
from .log import (CommitConflict, DeltaLog, Snapshot, catalog_index_key,
                  catalog_index_version)
from .compression import (CompressionSpec, UnknownCodecError, available_codecs,
                          byte_shuffle, byte_unshuffle, decode_frame,
                          encode_frame, frame_info, parse_compression,
                          register_compressor, set_unshuffle_kernel)
from .io import (BlockCache, ReadExecutor, ReadStats, get_default_executor,
                 set_default_executor)
from .table import (CompactResult, DeltaTable, UploadGuard, VacuumResult,
                    file_overlaps)
from . import columnar
from . import device
from .device import ChunkAssembler, DeviceReadInfo, to_device

__all__ = [
    "InMemoryObjectStore", "LatencyModel", "LocalFSObjectStore", "ObjectStore",
    "FaultInjectingObjectStore", "FaultRule", "InjectedFault",
    "ObjectNotFoundError", "PutIfAbsentError", "CommitConflict", "DeltaLog",
    "Snapshot", "DeltaTable", "file_overlaps", "columnar", "device",
    "BlockCache", "ReadExecutor", "ReadStats", "get_default_executor",
    "set_default_executor", "CompactResult", "VacuumResult", "UploadGuard",
    "catalog_index_key", "catalog_index_version",
    "CompressionSpec", "UnknownCodecError", "available_codecs",
    "byte_shuffle", "byte_unshuffle", "decode_frame", "encode_frame",
    "frame_info", "parse_compression", "register_compressor",
    "set_unshuffle_kernel", "ChunkAssembler", "DeviceReadInfo", "to_device",
]
