"""dbrx-132b [moe]: 40L d6144 48H (GQA kv=8) ff10752 v100352, 16 experts
top-4 fine-grained [hf:databricks/dbrx-base; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10_752, vocab_size=100_352, head_dim=128,
    n_experts=16, experts_per_token=4, moe_d_ff=10_752,
    rope_theta=500_000.0, tied_embeddings=False,
)
