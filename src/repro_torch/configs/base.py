"""Architecture configuration schema (plain data).

The port's copy of ``repro/configs/base.py``: the fields the port reads,
under the same names, and the same :func:`reduced` scaling of them, so
a configuration here and its JAX twin describe the same network.  The
MoE, SSD and frontend sizes and the sharding and training-policy fields
of the JAX schema are left out until a slice reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    # attention options
    qkv_bias: bool = False              # qwen2 style
    qk_norm: bool = False               # qwen3 style
    rope_theta: float = 10_000.0
    window: int | None = None           # local-attention window (hybrid)
    # layer pattern for hybrids: tuple of "attn" | "local" | "rglru" | "ssd"
    # cycled over n_layers; () -> all global attention (or all ssd for ssm)
    layer_pattern: tuple[str, ...] = ()
    # RG-LRU
    conv_width: int = 4
    rglru_width: int = 0                # 0 -> d_model
    # what later slices run; LM refuses a config that sets them
    n_experts: int = 0                  # MoE
    encoder_layers: int = 0             # encoder-decoder
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    tied_embeddings: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.layer_pattern:
            return tuple(self.layer_pattern[i % len(self.layer_pattern)]
                         for i in range(self.n_layers))
        if self.family == "ssm":
            return ("ssd",) * self.n_layers
        return ("attn",) * self.n_layers


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU tests (the JAX ``reduced``)."""
    scale = dict(
        n_layers=min(cfg.n_layers, 2 if not cfg.layer_pattern
                     else len(cfg.layer_pattern)),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        rglru_width=128 if cfg.rglru_width else 0,
        window=min(cfg.window, 32) if cfg.window else None,
        dtype="float32",
        param_dtype="float32",
    )
    scale.update(overrides)
    return dataclasses.replace(cfg, **scale)
