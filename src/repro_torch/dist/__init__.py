"""Distribution rules of the port: how every tensor lays out over a
``DeviceMesh`` (``sharding``)."""
from . import sharding

__all__ = ["sharding"]
