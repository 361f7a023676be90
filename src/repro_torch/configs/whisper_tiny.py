"""whisper-tiny [audio] — enc-dec, conv frontend STUB. [arXiv:2212.04356].

input_specs() provides precomputed log-mel frame embeddings
(B, seq/4, d_model) for the encoder; the decoder is the assigned 4L stack
with self + cross attention. Decode cells exercise the decoder KV cache;
long_500k is skipped (out of family for 30-second audio windows).
"""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    rope_theta=10_000.0,
    is_encoder_decoder=True, n_encoder_layers=4, encoder_seq_divisor=4,
    sharding_profile="tp",
    supports_long_context=False,
))
