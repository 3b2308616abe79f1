"""Flash-decode in plain torch: one query per head against a cache.

The port's copy of ``decode_attention`` from
``repro/kernels/chunked_attention.py``.  That module is the XLA twin of
the flash kernel, not a Pallas kernel, so this stays plain torch: an
online softmax over key chunks with an additive bias, never the whole
(B, Hkv, G, S) probability tensor at once.  Serving only (no backward).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
CHUNK = 1024                    # keys per online-softmax step, at most


def _pick_chunk(s: int, target: int) -> int:
    """Largest divisor of ``s`` that is <= target."""
    c = min(target, s)
    while c > 1 and s % c:
        c -= 1
    return max(c, 1)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """q: (B, Hkv, G, hd); k, v: (B, Hkv, S, hd); bias: (B, S) additive
    (0 = attend, ``NEG_INF`` = masked ring-buffer slot).  Scores are
    scaled by ``1 / sqrt(hd)``.  Returns (B, Hkv, G, hd) in q's dtype."""
    b, hkv, g, d = q.shape
    s = k.shape[2]
    kc = _pick_chunk(s, CHUNK)
    qf = q.float() * (1.0 / d ** 0.5)
    bf = bias.float()
    m = torch.full((b, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=q.device)
    for i in range(0, s, kc):
        kj = k[:, :, i:i + kc].float()
        vj = v[:, :, i:i + kc].float()
        sc = torch.einsum("bkgd,bksd->bkgs", qf, kj) \
            + bf[:, None, None, i:i + kc]
        m_new = torch.clamp(torch.maximum(m, sc.amax(-1)), min=0.8 * NEG_INF)
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgs,bksd->bkgd", p, vj)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (acc / l[..., None]).to(q.dtype)
