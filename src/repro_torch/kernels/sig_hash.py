"""murmur3 row signatures: the hand CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/sig_hash.py::sig_hash``
(``_hash_block``, ``_sig_hash_kernel``, ``_sig_hash_kernel_batched``).
The kernel is ``csrc/sig_hash.cu``: one thread per row, grid
``(cdiv(N, 256), C)``, the column mask and the padded-row sentinel
applied inside, so the candidate-masked ``(C, N, K)`` stack the
reference materializes never exists.

What bounds it on an H100: per masked row ``7K + 4`` IMADs on the FMA
pipe and ``7K + 14`` shifts and logic ops on the INT32 pipe, each pipe
64 lanes per clock per SM, against ``4K + 8`` bytes of traffic.  At the
sweep's (N=2^21, K=8, C=8) the busier INT32 pipe's floor (0.070 ms)
and HBM's (0.061 ms) nearly meet; the kernel keeps both hash lanes in
registers and reads the parent once per candidate.

Dispatch goes by the tensor's device: a CPU tensor runs
:func:`sig_hash_plain`, a CUDA tensor launches the kernel (or raises).
``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from . import ref

launches = 0


def _check_args(mat, valid, col_masks):
    if mat.dtype != torch.int32:
        raise TypeError(f"sig_hash takes int32 rows, got {mat.dtype}")
    if mat.ndim not in (2, 3):
        raise ValueError(f"expected (N, K) or (C, N, K), got {tuple(mat.shape)}")
    if col_masks is not None:
        if mat.ndim != 2:
            raise ValueError("col_masks needs an (N, K) parent")
        if col_masks.dtype != torch.int32 or col_masks.ndim != 2 or \
                col_masks.shape[1] != mat.shape[1]:
            raise ValueError(f"col_masks must be (C, {mat.shape[1]}) int32, "
                             f"got {tuple(col_masks.shape)} {col_masks.dtype}")
    c = (col_masks.shape[0] if col_masks is not None
         else mat.shape[0] if mat.ndim == 3 else 1)
    n = mat.shape[-2]
    shapes = ((n,),) if mat.ndim == 2 and col_masks is None else ((n,), (c, n))
    if valid is not None and (valid.dtype != torch.bool
                              or tuple(valid.shape) not in shapes):
        raise ValueError(f"valid must be bool of shape {shapes}, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    return c, n


def sig_hash_plain(mat: torch.Tensor, valid: torch.Tensor | None = None,
                   col_masks: torch.Tensor | None = None) -> torch.Tensor:
    """What the kernel computes, in plain torch (materializes the masked
    stack).  Same arguments and result as :func:`sig_hash`."""
    _check_args(mat, valid, col_masks)
    x = mat if col_masks is None else mat[None, :, :] * col_masks[:, None, :]
    sig = ref.row_signature_ref(x)
    if valid is not None:
        # (N,) -> (N, 1) and (C, N) -> (C, N, 1): per-candidate alignment
        sig = torch.where(valid[..., None], sig.view(torch.int32),
                          -1).view(torch.uint32)
    return sig


def sig_hash(mat: torch.Tensor, valid: torch.Tensor | None = None,
             col_masks: torch.Tensor | None = None) -> torch.Tensor:
    """Row signatures ``[hi, lo]`` as uint32.

    * ``mat`` (N, K) int32, no masks -> (N, 2);
    * ``mat`` (C, N, K) int32 -> (C, N, 2), candidate c hashing ``mat[c]``;
    * ``mat`` (N, K) with ``col_masks`` (C, K) -> (C, N, 2), candidate c
      hashing ``mat * col_masks[c]`` (the fused sweep form).

    ``valid``: bool (N,) or (C, N); rows where it is False get the
    all-ones ``SIG_SENTINEL`` in both lanes.
    """
    global launches
    if mat.device.type == "cpu":
        return sig_hash_plain(mat, valid, col_masks)
    if mat.device.type != "cuda":
        raise ValueError(f"sig_hash runs on cpu or cuda, not {mat.device}")
    c, n = _check_args(mat, valid, col_masks)
    k = mat.shape[-1]
    for name, t in (("mat", mat), ("col_masks", col_masks), ("valid", valid)):
        if t is not None and (t.device != mat.device or not t.is_contiguous()):
            raise ValueError(f"sig_hash: {name} must be contiguous on "
                             f"{mat.device}")
    if k < 1 or c > 65535:
        raise ValueError(f"sig_hash takes K >= 1 and C <= 65535, got K={k}, "
                         f"C={c}")
    out_shape = (n, 2) if mat.ndim == 2 and col_masks is None else (c, n, 2)
    out = torch.empty(out_shape, dtype=torch.uint32, device=mat.device)
    if n == 0 or c == 0:
        return out
    from .build import check, library
    err = library().repro_sig_hash(
        mat.data_ptr(), n, k, n * k if mat.ndim == 3 else 0,
        col_masks.data_ptr() if col_masks is not None else None, c,
        valid.data_ptr() if valid is not None else None,
        n if valid is not None and valid.ndim == 2 else 0,
        out.data_ptr(), torch.cuda.current_stream(mat.device).cuda_stream)
    check(err, "sig_hash")
    launches += 1
    return out
