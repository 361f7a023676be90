"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, d_ff=0 (blocks carry their own
up/down projections). [arXiv:2405.04517; unverified]. Superblocks of
7 mLSTM + 1 sLSTM (the paper's 7:1 ratio); recurrent decode state is O(1)
in sequence length so all long-context cells run."""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=256,
    ssm_expand=2, ssm_chunk=128,
    xlstm_slstm_every=8,
    sharding_profile="tp",
    supports_long_context=True,
))
