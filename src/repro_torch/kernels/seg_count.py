"""Segment boundaries over sorted signatures: the hand CUDA kernel and its
plain version.

Replaces the Pallas TPU kernel ``repro/kernels/seg_count.py::
seg_boundaries`` (``_seg_kernel``, ``_seg_kernel_batched``).  The kernel
is ``csrc/seg_count.cu``: grid ``(cdiv(N, 1024), C)``, thread i compares
row i with row i - 1 through an offset load (no materialized ``prev``
copy, no padding), row 0 of each candidate is always a boundary, and
each block adds its warp-shuffle sum into a zeroed ``(C,)`` count with
one integer ``atomicAdd``.

What bounds it on an H100: HBM -- ``C * N * 8`` bytes read and
``C * N * 4`` written, one compare per row; the design makes one
coalesced 8-byte load per row (the neighbour load hits L1) and one
atomic per 1024 rows.

Dispatch goes by the tensor's device: a CPU tensor runs
:func:`seg_boundaries_plain`, a CUDA tensor launches the kernel (or
raises).  ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from . import ref

launches = 0


def _check_args(sig_sorted):
    if sig_sorted.dtype != torch.uint32 or sig_sorted.ndim not in (2, 3) \
            or sig_sorted.shape[-1] != 2:
        raise ValueError(f"seg_boundaries takes (N, 2) or (C, N, 2) uint32, "
                         f"got {tuple(sig_sorted.shape)} {sig_sorted.dtype}")


def seg_boundaries_plain(sig_sorted: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, in plain torch.  Same arguments and
    result as :func:`seg_boundaries`."""
    _check_args(sig_sorted)
    b = ref.seg_boundaries_ref(sig_sorted)
    return b, b.sum(dim=-1, dtype=torch.int32)


def seg_boundaries(sig_sorted: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted (N, 2) signatures -> ((N,) int32 boundaries, () int32
    segment count); a (C, N, 2) stack, each candidate sorted along its
    own row axis, -> ((C, N) boundaries, (C,) counts)."""
    global launches
    if sig_sorted.device.type == "cpu":
        return seg_boundaries_plain(sig_sorted)
    if sig_sorted.device.type != "cuda":
        raise ValueError(f"seg_boundaries runs on cpu or cuda, not "
                         f"{sig_sorted.device}")
    _check_args(sig_sorted)
    if not sig_sorted.is_contiguous():
        raise ValueError("seg_boundaries: signatures must be contiguous")
    batched = sig_sorted.ndim == 3
    c = sig_sorted.shape[0] if batched else 1
    n = sig_sorted.shape[-2]
    if c > 65535:
        raise ValueError(f"seg_boundaries takes C <= 65535, got {c}")
    bounds = torch.empty(sig_sorted.shape[:-1], dtype=torch.int32,
                         device=sig_sorted.device)
    counts = torch.zeros((c,), dtype=torch.int32, device=sig_sorted.device)
    if n and c:
        from .build import check, library
        err = library().repro_seg_count(
            sig_sorted.data_ptr(), n, c, bounds.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(sig_sorted.device).cuda_stream)
        check(err, "seg_count")
        launches += 1
    return bounds, counts if batched else counts[0]
