"""Training modules of the port: AdamW, the plain and compressed train
steps, block-top-k gradient compression and delta checkpoints."""
from . import checkpoint, grad_compress, optimizer, trainer

__all__ = ["checkpoint", "grad_compress", "optimizer", "trainer"]
