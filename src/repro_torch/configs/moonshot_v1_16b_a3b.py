"""moonshot-v1-16b-a3b [moe]: 48L d2048 16H (GQA kv=16) ff1408 v163840,
64 experts top-6 (kimi/moonlight) [hf:moonshotai/Moonlight-16B-A3B; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163_840, head_dim=128,
    n_experts=64, experts_per_token=6, moe_d_ff=1408,
    rope_theta=50_000.0, tied_embeddings=True,
)
