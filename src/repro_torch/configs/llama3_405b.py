"""llama3-405b [dense]: 126L d16384 128H (GQA kv=8) ff53248 v128256
[arXiv:2407.21783; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16_384, n_heads=128, n_kv_heads=8,
    d_ff=53_248, vocab_size=128_256, head_dim=128,
    rope_theta=500_000.0, tied_embeddings=False,
    optimizer="adafactor", fsdp=True, seq_shard=True, grad_accum=8,
)
