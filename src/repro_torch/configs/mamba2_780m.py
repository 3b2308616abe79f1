"""mamba2-780m [ssm]: 48L d1536 attn-free v50280 ssm_state=128 -- SSD
(state-space duality) [arXiv:2405.21060; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50_280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    tied_embeddings=True, seq_shard=True,
)
