"""The signature and segment operations of the device path.

``row_signature`` and ``seg_boundaries`` are the kernel wrappers
themselves (``sig_hash.py``, ``seg_count.py``) under the reference's
names: each runs where its tensor lies, the hand kernel on a CUDA
tensor, its plain version on a CPU tensor.  There is no flag and no
fallback: a CUDA launch that fails raises.
"""
from __future__ import annotations

import torch

from .ref import SIG_SENTINEL  # noqa: F401  (re-exported)
from .seg_count import seg_boundaries  # noqa: F401  (re-exported)
from .sig_hash import sig_hash as row_signature  # noqa: F401  (re-exported)

_SIGN = -(1 << 63)


def resolve_device(device) -> torch.device:
    """``torch.device`` for a device entry point.  A CUDA device on a host
    without CUDA raises here: the device paths never run quietly on the
    CPU, the caller has to ask for it (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            "device='cpu' to run the device path's plain torch version")
    return dev


def sort_signatures(sig: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic sort of (..., N, 2) uint32 signatures along the row
    axis; returns (sorted, order).  Batched stacks sort per candidate.

    The two lanes pack into one int64 key ``hi << 32 | lo`` (a bit view,
    no arithmetic) with the sign bit flipped, so signed order equals the
    unsigned ``(hi, lo)`` order of the reference's ``jnp.lexsort``; the
    sort is stable, so ties keep row order as there.
    """
    s = sig.view(torch.int32)
    # little-endian: the int64 of the pair [lo, hi] is hi << 32 | lo
    key = s[..., [1, 0]].contiguous().view(torch.int64).squeeze(-1) ^ _SIGN
    sorted_key, order = torch.sort(key, dim=-1, stable=True)
    lanes = (sorted_key ^ _SIGN).unsqueeze(-1).view(torch.int32)
    return lanes[..., [1, 0]].contiguous().view(torch.uint32), order
