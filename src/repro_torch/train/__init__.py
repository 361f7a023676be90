"""Training-side modules of the port: block-top-k gradient compression."""
from . import grad_compress

__all__ = ["grad_compress"]
