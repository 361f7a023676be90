"""mixtral-8x22b [moe] — 8 experts top-2, SWA. [arXiv:2401.04088; hf].

About 140B params; sliding-window attention of width 4096.
"""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    rope_theta=1_000_000.0, window=4096,
    n_experts=8, top_k=2, moe_d_ff=16384,
    sharding_profile="fsdp_tp",
    supports_long_context=True,
))
