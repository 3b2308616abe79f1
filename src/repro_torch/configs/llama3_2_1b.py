"""llama3.2-1b [dense]: 16L d2048 32H (GQA kv=8) ff8192 v128256
[hf:meta-llama/Llama-3.2-1B; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=128_256, head_dim=64,
    rope_theta=500_000.0, tied_embeddings=True, seq_shard=True,
)
