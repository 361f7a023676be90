"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]. SWA window 4096 => O(T*w) attention, so the
long_500k decode cell runs (window-capped KV).
"""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab_size=32000, head_dim=120,
    rope_theta=10_000.0, window=4096,
    sharding_profile="tp",
    supports_long_context=True,
))
