"""glm4-9b [dense] — RoPE, extreme GQA (kv=2). [hf:THUDM/glm-4-9b; hf]."""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151552, head_dim=128,
    rope_theta=10_000.0,
    sharding_profile="tp",
    supports_long_context=False,
))
