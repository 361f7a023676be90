"""Serving layer of the port: weight handles, the inference engine, and
the gateway.

``repo.ModelRepo`` (via ``store.models(prefix)``) is the weights API,
``engine.ServeEngine`` runs continuous-batching inference on the card, and
``gateway.Gateway`` is the multi-tenant admission and scheduling layer in
front of the store. ``save_weights`` / ``load_weights`` are deprecated
shims kept as in the reference.
"""

from .engine import Request, ServeEngine, load_weights, save_weights
from .gateway import Gateway, RetryAfter, TenantPolicy, jain_index
from .repo import ModelRepo

__all__ = [
    "Gateway",
    "ModelRepo",
    "Request",
    "RetryAfter",
    "ServeEngine",
    "TenantPolicy",
    "jain_index",
    "load_weights",
    "save_weights",
]
