"""Architecture configuration schema (plain data).

The port's copy of ``repro/configs/base.py``: the fields the port reads,
under the same names, and the same :func:`reduced` scaling of them, so
a configuration here and its JAX twin describe the same network, and
the same derived sizes (``homogeneous``, ``d_inner``, ``ssm_heads``,
``n_params`` ...).  The sharding and training-policy fields of the JAX
schema are left out until a slice reads them.
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
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    # RG-LRU
    rglru_width: int = 0                # 0 -> d_model
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                   # per-expert hidden (0 -> d_ff)
    # encoder-decoder and the frontend stubs
    encoder_layers: int = 0
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    frontend_tokens: int = 1500         # encoder positions / image patches
    frontend_dim: int = 0               # stub embedding dim (0 -> d_model)
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

    @property
    def homogeneous(self) -> bool:
        p = self.pattern
        return all(t == p[0] for t in p)

    @property
    def sub_quadratic(self) -> bool:
        """True if serving cost is sub-quadratic in sequence length (no
        global-attention layer)."""
        return all(t in ("ssd", "rglru", "local") for t in self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), the JAX
        schema's count."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d * (1 if self.tied_embeddings else 2)
        for kind in self.pattern:
            if kind in ("attn", "local"):
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * hd * d
                if self.n_experts:
                    e_ff = self.moe_d_ff or f
                    total += d * self.n_experts + \
                        3 * self.n_experts * d * e_ff
                else:
                    total += 3 * d * f
            elif kind == "ssd":
                di, ns, hh = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * ns + hh) + di * d
            elif kind == "rglru":
                w = self.rglru_width or d
                total += 2 * d * w + w * d + 2 * w * w  # in/gate/out + gates
                total += 3 * d * f                      # the block's MLP
        total += self.encoder_layers * (
            d * hd * (self.n_heads + 2 * self.n_kv_heads)
            + self.n_heads * hd * d + 3 * d * f)
        return total

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.n_params
        e_ff = self.moe_d_ff or self.d_ff
        per_layer_unused = 3 * (self.n_experts - self.experts_per_token) \
            * self.d_model * e_ff
        return self.n_params - per_layer_unused * self.n_layers


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
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32,
        ssm_chunk=16,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2)
        if cfg.experts_per_token else 0,
        moe_d_ff=64 if cfg.n_experts else 0,
        rglru_width=128 if cfg.rglru_width else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_tokens=16,
        frontend_dim=64 if cfg.frontend_dim else 0,
        window=min(cfg.window, 32) if cfg.window else None,
        dtype="float32",
        param_dtype="float32",
    )
    scale.update(overrides)
    return dataclasses.replace(cfg, **scale)
