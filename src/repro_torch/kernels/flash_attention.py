"""GQA forward attention: two hand CUDA kernels and their plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (``_flash_kernel``).  The wrapper routes each call by
type to one of two kernels, with no fallback between them:

- bfloat16 -> ``csrc/flash_attention_sm90.cu``, on the tensor cores: one
  block per (batch, q-head, 128-row query tile), a producer thread
  feeding Q once and 64-key K and V tiles through a two-stage TMA ring,
  two consumer warpgroups running S = QK^T and O += PV as ``wgmma`` with
  an online softmax in registers between them;
- float32 -> ``csrc/flash_attention.cu``, on the float32 CUDA cores (the
  tensor cores would need TF32, which cannot meet float32's 1e-5).

Both keep m, l and the accumulator in float32, read the KV head in
place (never repeated), apply the causal / window / ``kpos < S`` masks
inside and skip KV tiles outside the band.  The tensor-core kernel
rounds the softmax weights to bf16 before PV (l sums them unrounded): a
relative change of at most 2^-9 per weight, which
:func:`bf16_row_limit` turns into a limit per query row.

What bounds them on an H100: ``4 * D`` flops per attended (query, key)
pair and head against one read of q, k, v and one write of the output.
At recurrentgemma-2b's prefill (8, 10, 2304, 256) bf16, window 2048,
the operations bound it: 0.217 ms at the 989 TFLOP/s bf16 tensor-core
rate, against 0.062 ms for the bytes.

Semantics, the port's stated choices: queries occupy the last T of S
positions (``qpos = r + S - T``); keys ``>= S`` never count (the Pallas
kernel's zero padding does count them when ``causal=False`` on a ragged
S, ROADMAP §3); a row with no key to attend is 0, as the Pallas kernel
gives and unlike ``mha_ref``'s NaN.

Dispatch goes by the tensor's device: a CPU tensor runs
:func:`flash_attention_plain`, a CUDA tensor launches a kernel (or
raises).  ``tensor_core_launches`` and ``cuda_core_launches`` count each
kernel's launches, ``launches`` their sum, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref

launches = 0                 # both kernels
tensor_core_launches = 0     # flash_attention_sm90.cu (bfloat16)
cuda_core_launches = 0       # flash_attention.cu (float32)

HEAD_DIMS = (64, 128, 256)          # the head sizes the kernels are built for
# C entry of the kernel for each input type
KERNELS = {torch.bfloat16: "repro_flash_attention_sm90",
           torch.float32: "repro_flash_attention"}


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


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """The C entry a CUDA call of ``dtype`` inputs with head size ``d``
    launches; raises for a type or a head size no kernel is built for."""
    if dtype not in KERNELS:
        raise TypeError(f"flash_attention kernels take bfloat16 (tensor "
                        f"cores) or float32 (CUDA cores), got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernels take head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    return KERNELS[dtype]


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


def bf16_row_limit(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   want: torch.Tensor, *, causal: bool = True,
                   window: int | None = None,
                   steps: int = 2) -> torch.Tensor:
    """How far the bf16 tensor-core kernel may lie from ``want``, the
    plain version's output on the same inputs: (B, Hq, T, 1) float32, a
    limit for each query row.

    Two roundings part them.  The kernel rounds each softmax weight p_k
    to bf16 (a relative change of at most 2^-9) before PV, and l sums the
    unrounded weights, so output j of a row moves by at most 2^-9 *
    sum_k p_k |v_kj|: the row's largest such sum, times 2^-9.  Then each
    side rounds its float32 output to bf16, at most half a step each:
    ``steps`` steps at the row's largest |want|, one step at magnitude m
    being 2^(floor(log2 m) - 7).  The float32 sums, which differ in order
    only, stay far below both.  A row with no key to attend gets 0.
    """
    group = q.shape[1] // k.shape[1]
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(),
                          k.repeat_interleave(group, dim=1).float())
    mask = ref.attention_mask(q.shape[2], k.shape[2], causal, window,
                              q.device)
    probs = torch.softmax(logits.masked_fill_(~mask, float("-inf")) /
                          q.shape[3] ** 0.5, dim=-1).nan_to_num_(0.0)
    del logits
    spread = torch.einsum("bhts,bhsd->bhtd", probs,
                          v.repeat_interleave(group, dim=1).float().abs())
    peak = want.float().abs().amax(dim=-1, keepdim=True)
    step = torch.exp2(torch.floor(torch.log2(peak)) - 7)    # 0 at peak 0
    return steps * step + 2.0 ** -9 * spread.amax(dim=-1, keepdim=True)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: (B, Hq, T, D); k, v: (B, Hkv, S, D) -> (B, Hq, T, D) in q's type,
    scores scaled by ``1 / sqrt(D)``.

    On CUDA: bfloat16 (tensor-core kernel) or float32 (CUDA-core
    kernel), contiguous, D in :data:`HEAD_DIMS`.
    """
    global launches, tensor_core_launches, cuda_core_launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check_args(q, k, v, window)
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    entry = kernel_for(q.dtype, d)
    for name, x in (("k", k), ("v", v), ("q", q)):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"on {q.device}")
        if x.data_ptr() % 16:       # the tensor maps' base alignment
            raise ValueError(f"flash_attention: {name} must start on a "
                             "16-byte boundary")
    if b > 65535 or hq > 65535 or max(t, s) >= 2**31:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} / S={s} "
                         "exceeds the launch grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    from .build import check, library
    err = getattr(library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        t, s, d, ctypes.c_float(1.0 / d ** 0.5), int(causal),
        0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, entry)
    if entry == KERNELS[torch.bfloat16]:
        tensor_core_launches += 1
    else:
        cuda_core_launches += 1
    launches += 1
    return out
