"""Hand-written CUDA kernels of the store's device read path.

Structure per kernel: ``csrc/<name>.cu`` holds the CUDA source with a plain
C interface, ``<name>.py`` its ctypes launcher (with a launch counter) and
its plain PyTorch version, ``ops.py`` the entry points that dispatch on the
operand's device, ``_build.py`` the nvcc build. Importing this package
neither builds nor loads anything.
"""
from . import block_gather, coo_scatter, ops, unshuffle
from .ops import unshuffle_host

KERNELS = (block_gather, unshuffle, coo_scatter)


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for mod in KERNELS:
        mod.launches = 0


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return {mod.__name__.rsplit(".", 1)[-1]: mod.launches for mod in KERNELS}


__all__ = ["block_gather", "coo_scatter", "ops", "unshuffle",
           "unshuffle_host", "KERNELS", "reset_launch_counts",
           "launch_counts"]
