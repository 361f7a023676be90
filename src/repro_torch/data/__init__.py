from . import ingest, pipeline, stream, synthetic
from .ingest import IngestWriter
from .stream import StreamLoader

__all__ = ["ingest", "pipeline", "stream", "synthetic", "IngestWriter",
           "StreamLoader"]
