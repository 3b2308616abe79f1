"""qwen2-0.5b [dense]: 24L d896 14H (GQA kv=2) ff4864 v151936 -- GQA + QKV
bias [arXiv:2407.10671; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151_936, head_dim=64,
    qkv_bias=True, rope_theta=1_000_000.0,
    # 14 heads / kv=2 divide no wide model axis, and at 0.5B pure data
    # parallelism beats tensor parallelism: tp=False
    tied_embeddings=True, tp=False, seq_shard=True,
)
