"""Architecture configuration — one frozen dataclass covers the whole zoo.

The port's copy of ``repro.models.config`` (plain data, field for field).
Every assigned architecture is an ``ArchConfig``; family-specific structure
(MoE, SSM, hybrid interleave, enc-dec, cross-attn) is driven by fields
rather than subclasses. The distribution and tiling fields
(``sharding_profile``, ``attn_chunk_*``) are kept so that a config means
the same in both packages; the port does not read them. ``remat_policy``
picks what :mod:`.transformer` keeps of each super-block for the backward
pass.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention flavour
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding-window attention width
    swa_every: int = 1                    # 1 = all layers windowed (if window)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_d_ff: Optional[int] = None        # expert FFN width (defaults d_ff)

    # SSM (mamba2 / xlstm)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128

    # hybrid (zamba2): one shared attention block applied every k SSM layers
    shared_attn_every: int = 0

    # xLSTM: layers per super-block; last one is sLSTM, rest mLSTM
    xlstm_slstm_every: int = 0

    # vlm (llama-3.2-vision): cross-attn layer leading every super-block
    cross_attn_every: int = 0
    n_image_tokens: int = 0

    # audio (whisper): encoder-decoder
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_divisor: int = 4          # stub frontend: frames = seq / divisor

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # distribution
    sharding_profile: str = "tp"          # tp | fsdp_tp
    remat_policy: str = "nothing_saveable"  # scan remat policy
    attn_chunk_q: int = 512               # flash attention tile sizes
    attn_chunk_kv: int = 1024

    # which shape cells apply (documented skips)
    supports_long_context: bool = False   # sub-quadratic path exists
    supports_decode: bool = True

    def kv_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    def reduced(self) -> "ArchConfig":
        """CPU-smoke-test twin: same family/topology, tiny sizes."""
        def shrink(v, lo, hi):
            return max(lo, min(v, hi))
        kw: Dict = dict(
            n_layers=shrink(self.n_layers // 8, 2, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab_size=512,
            head_dim=16,
            n_image_tokens=16 if self.n_image_tokens else 0,
            window=min(self.window, 16) if self.window else None,
            attn_chunk_q=16, attn_chunk_kv=16,
            ssm_chunk=8,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.n_experts else None,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            dtype="float32",
        )
        # keep the interleave structure but make it fit the reduced depth
        if self.shared_attn_every:
            kw["shared_attn_every"] = 2
        if self.cross_attn_every:
            kw["cross_attn_every"] = 2
        if self.xlstm_slstm_every:
            kw["xlstm_slstm_every"] = 2
        if self.shared_attn_every or self.cross_attn_every or self.xlstm_slstm_every:
            kw["n_layers"] = 4
        return replace(self, **kw)


_REGISTRY: Dict[str, ArchConfig] = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # populate from the configs package lazily
        from .. import configs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    from .. import configs  # noqa: F401
    return tuple(sorted(_REGISTRY))
