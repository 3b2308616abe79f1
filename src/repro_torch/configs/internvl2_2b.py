"""internvl2-2b [vlm]: 24L d2048 16H (GQA kv=8) ff8192 v92553 -- InternViT +
InternLM2 backbone; vision frontend is a STUB (precomputed patch embeddings,
256 tokens of dim 1024 projected into the LM) [arXiv:2404.16821; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92_553, head_dim=128,
    rope_theta=1_000_000.0,
    frontend="vision_stub", frontend_tokens=256, frontend_dim=1024,
    tied_embeddings=True,
)
