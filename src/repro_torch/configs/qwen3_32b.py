"""qwen3-32b [dense]: 64L d5120 64H (GQA kv=8) ff25600 v151936 -- qk_norm
[hf:Qwen/Qwen3-8B; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    d_ff=25_600, vocab_size=151_936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
    tied_embeddings=False,
    fsdp=True, seq_shard=True,
)
