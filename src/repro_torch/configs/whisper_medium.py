"""whisper-medium [audio]: 24L d1024 16H ff4096 v51865 -- enc-dec backbone;
conv frontend is a STUB (precomputed frame embeddings) [arXiv:2212.04356;
unverified].  rope_theta=0 selects learned absolute positions (whisper
style)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51_865, head_dim=64,
    rope_theta=0.0, encoder_layers=24,
    frontend="audio_stub", frontend_tokens=1500,
    tied_embeddings=True, seq_shard=True,
)
