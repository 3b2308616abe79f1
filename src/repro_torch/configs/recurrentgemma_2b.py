"""recurrentgemma-2b [hybrid]: 26L d2560 10H (GQA kv=1) ff7680 v256000 --
RG-LRU + local attention, 1 attn : 2 recurrent [arXiv:2402.19427; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256_000, head_dim=256,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048, rglru_width=2560,
    tied_embeddings=True, seq_shard=True,
)
