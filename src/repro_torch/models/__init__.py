"""Models of the port: the architecture configs and the stacks of all six
families (attention + MLP/MoE, and the state-space blocks of ``ssm``) in
plain PyTorch."""
from .config import ArchConfig, get_arch, list_archs, register_arch
from . import attention, layers, moe, ssm, transformer

__all__ = ["ArchConfig", "get_arch", "list_archs", "register_arch",
           "attention", "layers", "moe", "ssm", "transformer"]
