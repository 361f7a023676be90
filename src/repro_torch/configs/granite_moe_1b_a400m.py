"""granite-moe-1b-a400m [moe] — 32 experts, top-8, tiny expert FFN (512).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    rope_theta=10_000.0,
    n_experts=32, top_k=8, moe_d_ff=512,
    sharding_profile="tp",
    supports_long_context=False,
))
