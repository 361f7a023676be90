"""zamba2-2.7b [hybrid] — Mamba2 backbone + one SHARED attention block
applied every 6 layers. [arXiv:2411.15242; hf]. ssm_state=64. SSM decode is
O(1)/token so all long-context cells run."""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    rope_theta=10_000.0,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    shared_attn_every=6,
    sharding_profile="tp",
    supports_long_context=True,
))
