"""Plain torch versions of the signature and segment kernels.

Each function here is the ground truth its hand kernel is held against
(``kernels/sig_hash.py``, ``kernels/seg_count.py``): the CPU tests run
them against ``repro.kernels.ref`` bit for bit, and ``chip_smoke.py``
runs them on the card beside the kernels.

torch has no ``<<``, ``>>`` or ``+`` on ``uint32``, so murmur3 runs in
int64 with ``& 0xFFFFFFFF`` after every multiply, shift and add: the
int64 products wrap, but their low 32 bits stay right.  Signatures leave
as ``uint32`` tensors (a bit view of int32), the dtype of the reference;
every computation on them goes through an int32 view.
"""
from __future__ import annotations

import torch

_C1 = 0xcc9e2d51
_C2 = 0x1b873593
_FM1 = 0x85ebca6b
_FM2 = 0xc2b2ae35
_SEED_HI = 0x9e3779b9
_M32 = 0xFFFFFFFF

# all-ones signature reserved for masked-out rows: every invalid row
# collapses into one sentinel segment the callers subtract back out
SIG_SENTINEL = 0xFFFFFFFF


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * _FM1) & _M32
    h = h ^ (h >> 13)
    h = (h * _FM2) & _M32
    return h ^ (h >> 16)


def _mm3_step(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    k = (k * _C1) & _M32
    k = _rotl32(k, 15)
    k = (k * _C2) & _M32
    h = h ^ k
    h = _rotl32(h, 13)
    return (h * 5 + 0xe6546b64) & _M32


def to_uint32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> the same bits as a uint32 tensor."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(
        torch.int32).view(torch.uint32)


def row_signature_ref(mat: torch.Tensor) -> torch.Tensor:
    """(..., N, K) int32 -> (..., N, 2) uint32 murmur3 row hashes.

    Lane 0 (hi) is seeded with the golden ratio and fed ``x ^
    0xdeadbeef``, lane 1 (lo) is seeded with 0; both finalize with
    ``fmix32(h ^ K)``.  Leading batch dimensions hash independently.
    """
    x = mat.to(torch.int64) & _M32        # int32 -> uint32 bit reinterpretation
    k = x.shape[-1]
    h_lo = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    h_hi = torch.full(x.shape[:-1], _SEED_HI, dtype=torch.int64,
                      device=x.device)
    for j in range(k):
        h_lo = _mm3_step(h_lo, x[..., j])
        h_hi = _mm3_step(h_hi, x[..., j] ^ 0xdeadbeef)
    h_lo = _fmix32(h_lo ^ k)
    h_hi = _fmix32(h_hi ^ k)
    return to_uint32(torch.stack([h_hi, h_lo], dim=-1))


def seg_boundaries_ref(sig_sorted: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) sorted signatures -> (..., N) int32; 1 at segment starts.

    Each leading-batch slice (candidate) gets its own always-set first
    boundary.
    """
    s = sig_sorted.view(torch.int32)
    diff = torch.any(s[..., 1:, :] != s[..., :-1, :], dim=-1)
    first = torch.ones(s.shape[:-2] + (1,), dtype=torch.int32,
                       device=s.device)
    return torch.cat([first, diff.to(torch.int32)], dim=-1)
