"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]. The vision frontend is a
STUB per the assignment: input_specs() supplies precomputed patch embeddings
(B, n_image_tokens, d_model); the backbone interleaves 8 gated cross-attn
layers into the 40-layer stack (superblocks of 1 cross + 4 self).
"""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5, n_image_tokens=1024,
    sharding_profile="tp",
    supports_long_context=False,   # full attention -> long_500k skipped
))
