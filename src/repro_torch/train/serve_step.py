"""Serve-step factories: prefill (build the cache) and decode (one token).

The port's copy of ``repro/train/serve_step.py``, greedy only: each step
returns the argmax token, the cache and the float32 next-token logits
it was chosen from.
"""
from __future__ import annotations

from typing import Callable


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


def make_decode_step(model) -> Callable:
    def decode(tokens, cache, positions):
        """tokens, positions: (B, 1).  Returns (next (B,) int32, cache,
        (B, V) f32)."""
        logits, cache = model.decode_step(tokens, cache, positions)
        last = logits[:, -1].float()
        return last.argmax(dim=-1).int(), cache, last
    return decode
