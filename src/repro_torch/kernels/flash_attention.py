"""GQA forward attention: the hand CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (``_flash_kernel``).  The kernel is
``csrc/flash_attention.cu``: one block per (batch, q-head, 64-row query
tile) looping over 32-key KV tiles in shared memory with an online
softmax, float32 ``m``, ``l`` and accumulator, the KV head read in place
(never repeated), the causal / window / ``kpos < S`` masks applied
inside, and KV tiles outside the band skipped.

What bounds it on an H100: ``4 * D`` flops per attended (query, key)
pair and head against one read of q, k, v and one write of the output.
At recurrentgemma-2b's prefill (8, 10, 2304, 256) bf16, window 2048,
the operations bound it: 0.217 ms at the 989 TFLOP/s bf16 tensor-core
rate, against 0.062 ms for the bytes.  This first version multiplies on
the float32 CUDA cores.

Semantics, the port's stated choices: queries occupy the last T of S
positions (``qpos = r + S - T``); keys ``>= S`` never count (the Pallas
kernel's zero padding does count them when ``causal=False`` on a ragged
S, ROADMAP §3); a row with no key to attend is 0, as the Pallas kernel
gives and unlike ``mha_ref``'s NaN.

Dispatch goes by the tensor's device: a CPU tensor runs
:func:`flash_attention_plain`, a CUDA tensor launches the kernel (or
raises).  ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref

launches = 0

HEAD_DIMS = (64, 256)               # the head sizes the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Hq, T, D), k = v (B, Hkv, S, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0 or \
            hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (Hq must be a multiple of Hkv)")
    if not (q.dtype == k.dtype == v.dtype) or not q.dtype.is_floating_point:
        raise TypeError(f"q, k, v must share one float type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    """What the kernel computes, in plain torch (materializes the (B, Hq,
    T, S) scores).  Same arguments and result as :func:`flash_attention`."""
    _check_args(q, k, v, window)
    out = ref.mha_ref(q, k, v, causal=causal, window=window)
    mask = ref.attention_mask(q.shape[2], k.shape[2], causal, window,
                              q.device)
    return torch.where(mask.any(dim=-1)[:, None], out, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: (B, Hq, T, D); k, v: (B, Hkv, S, D) -> (B, Hq, T, D) in q's type,
    scores scaled by ``1 / sqrt(D)``.

    On CUDA: float32 or bfloat16, contiguous, D in :data:`HEAD_DIMS`.
    """
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check_args(q, k, v, window)
    for name, x in (("k", k), ("v", v), ("q", q)):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if b > 65535 or hq > 65535 or max(t, s) >= 2**31:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} / S={s} "
                         "exceeds the launch grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    from .build import check, library
    err = library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        t, s, d, ctypes.c_float(1.0 / d ** 0.5), int(causal),
        0 if window is None else int(window), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention")
    launches += 1
    return out
