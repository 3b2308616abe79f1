"""Serve-step factories: prefill (build the cache) and decode (one token).

The port's copy of ``repro/train/serve_step.py``.  Each step returns the
chosen token, the cache and the float32 next-token logits it was chosen
from.  Prefill is greedy; decode is greedy at ``temperature == 0`` and
otherwise samples ``argmax(logits / T + g)`` with standard Gumbel noise
``g`` -- what ``jax.random.categorical`` computes -- drawn from an
explicit ``torch.Generator`` (or handed in).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.common import TSpec


def make_prefill_step(model, *, cache_len: int) -> Callable:
    def prefill(tokens, frontend_embeds=None):
        """tokens: (B, T); ``frontend_embeds``: the stub's frame or patch
        embeddings (whisper, the VLM).  Returns (next (B,) int32, cache,
        (B, V) f32)."""
        logits, cache = model.prefill(tokens, cache_len=cache_len,
                                      frontend_embeds=frontend_embeds)
        last = logits[:, -1].float()
        return last.argmax(dim=-1).int(), cache, last
    return prefill


def gumbel_noise(shape, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """Standard Gumbel samples, float32: ``-log(-log(u))`` for ``u``
    uniform in (0, 1) (the open interval of the smallest positive float32
    up to 1, as ``jax.random.gumbel`` draws it)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def make_decode_step(model, *, temperature: float = 0.0) -> Callable:
    def decode(tokens, cache, positions, generator=None, noise=None):
        """tokens, positions: (B, 1).  With ``temperature > 0`` the token
        is ``argmax(logits / T + noise)``: ``noise`` (B, V) float32 if
        given, else Gumbel noise from ``generator`` on the logits'
        device.  Returns (next (B,) int32, cache, (B, V) f32)."""
        logits, cache = model.decode_step(tokens, cache, positions)
        last = logits[:, -1].float()
        if temperature > 0.0:
            if noise is None:
                if generator is None:
                    raise ValueError("temperature sampling needs a "
                                     "generator or noise")
                noise = gumbel_noise(last.shape, generator, last.device)
            return (last / temperature + noise.to(last.device)).argmax(
                dim=-1).int(), cache, last
        return last.argmax(dim=-1).int(), cache, last
    return decode


def decode_input_specs(model, batch: int, cache_len: int) -> dict:
    """The :class:`TSpec` of each input of one decode step: tokens,
    positions and the per-layer cache ``model.cache_specs`` gives."""
    return {"tokens": TSpec((batch, 1), "int32", init="zeros"),
            "positions": TSpec((batch, 1), "int32", init="zeros"),
            "cache": model.cache_specs(batch, cache_len)}
