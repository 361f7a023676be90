"""Hand-written CUDA kernels of the port: the store's device read path
(``block_gather``, ``unshuffle``, ``coo_scatter``) and block-top-k gradient
compression (``block_norms``, ``block_scatter``, with ``block_gather``),
and the optimizer's fused AdamW step (``adamw``).

Structure per kernel: ``csrc/<name>.cu`` holds the CUDA source with a plain
C interface, ``<name>.py`` its ctypes launcher (with a launch counter) and
its plain PyTorch version, ``ops.py`` the entry points that dispatch on the
operand's device, ``_build.py`` the nvcc build. Importing this package
neither builds nor loads anything.
"""
from . import (adamw, block_gather, block_norms, block_scatter, coo_scatter,
               ops, unshuffle)
from .ops import unshuffle_host

KERNELS = (block_gather, unshuffle, coo_scatter, block_norms, block_scatter,
           adamw)


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for mod in KERNELS:
        mod.launches = 0


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return {mod.__name__.rsplit(".", 1)[-1]: mod.launches for mod in KERNELS}


__all__ = ["adamw", "block_gather", "block_norms", "block_scatter",
           "coo_scatter", "ops", "unshuffle", "unshuffle_host", "KERNELS",
           "reset_launch_counts", "launch_counts"]
