"""Models of the port: the architecture configs and the attention +
MLP/MoE stack (``dense`` and ``moe`` families) in plain PyTorch."""
from .config import ArchConfig, get_arch, list_archs, register_arch
from . import attention, layers, moe, transformer

__all__ = ["ArchConfig", "get_arch", "list_archs", "register_arch",
           "attention", "layers", "moe", "transformer"]
