"""phi3-mini-3.8b [dense] — RoPE SwiGLU, kv=32 (full MHA).
[arXiv:2404.14219; unverified]."""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    rope_theta=10_000.0,
    sharding_profile="tp",
    supports_long_context=False,
))
