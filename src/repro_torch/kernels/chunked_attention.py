"""Attention in plain torch around the flash kernel: training's
differentiable attention, and flash-decode.

The port's copy of ``repro/kernels/chunked_attention.py``.  That module
is the XLA twin of the flash kernel, not a Pallas kernel, so this stays
plain torch:

- :func:`chunked_attention`, one ``torch.autograd.Function`` on both
  devices.  Its forward on a CUDA tensor is the flash kernel with its
  row log-sum-exp (``flash_attention(..., return_lse=True)``); on a CPU
  tensor the plain chunked online softmax (the JAX ``_fwd``).  Its
  backward, on both, is the JAX ``_attn_bwd`` in plain torch: per key
  chunk it recomputes P from the LSE, with grouped einsums for GQA (K
  and V never repeated to Hq) and float32 inside.  No Pallas kernel has
  a backward, so a hand-written backward kernel is later performance
  work.  Under ``no_grad`` (or with no input that needs a gradient) it
  is the flash wrapper alone: nothing saved, no LSE asked for.
- :func:`decode_attention`: an online softmax over key chunks with an
  additive bias, never the whole (B, Hkv, G, S) probability tensor at
  once.  Serving only (no backward).
- :func:`decode_attention_sharded`: the same over a cache whose sequence
  is split over a mesh axis, single-controller: each shard's online
  softmax on its entry's device, then the three combines the JAX
  ``pmax``/``psum`` do.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .flash_attention import EMPTY_LSE, flash_attention

NEG_INF = -1e30
CHUNK = 1024                    # keys per online-softmax step, at most
TRAIN_CHUNK = 512               # keys per step of the training forward and
#                                 backward (the JAX ``chunked_attention``)


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
    _, l, acc = _decode_stats(q, k, v, bias)
    l = torch.clamp(l, min=1e-30)
    return (acc / l[..., None]).to(q.dtype)


def _decode_stats(q, k, v, bias):
    """The online softmax of :func:`decode_attention` before its division:
    (m, l, acc), float32, (B, Hkv, G), (B, Hkv, G), (B, Hkv, G, hd)."""
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
    return m, l, acc


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def decode_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor, *, mesh,
                             seq_axis: str = "model", q_spec=None,
                             kv_spec=None, bias_spec=None) -> torch.Tensor:
    """Flash-decode over a SEQUENCE-SHARDED KV cache (the JAX
    ``decode_attention_sharded``), single-controller like
    ``models.blocks.moe_shard_map``.

    The cache's S splits into equal contiguous shards over the entries of
    ``seq_axis``; where ``kv_spec`` shards the batch (its first entry:
    mesh axes), the batch splits over those axes' entries too.  Each
    shard runs :func:`decode_attention`'s online softmax on its local
    keys on its entry's device, and the shards' statistics combine as the
    JAX ``pmax``/``psum`` do: ``m* = max m``, ``l* = sum l e^(m - m*)``,
    ``acc* = sum acc e^(m - m*)``, out = ``acc* / l*``.

    q: (B, Hkv, G, hd) (``q_spec``: replicated over ``seq_axis``); k, v:
    (B, Hkv, S, hd) sharded over ``seq_axis`` on dim 2 (``kv_spec``, by
    default ``P(None, None, seq_axis, None)``); bias: (B, S) additive
    (``bias_spec``, by default ``P(None, seq_axis)``).  Returns (B, Hkv,
    G, hd) in q's dtype on q's device.
    """
    ks = tuple(kv_spec) if kv_spec is not None else (None, None, seq_axis,
                                                      None)
    bs = tuple(bias_spec) if bias_spec is not None else (None, seq_axis)
    qs = tuple(q_spec) if q_spec is not None else (None,) * 4
    if ks[2] != seq_axis or bs[1] != seq_axis or seq_axis in _axes(qs[2]):
        raise ValueError(f"decode_attention_sharded splits S over "
                         f"{seq_axis!r}: kv_spec {ks}, bias_spec {bs}, "
                         f"q_spec {qs}")
    names = list(mesh.axis_names)
    b_axes = _axes(ks[0])
    if _axes(bs[0]) != b_axes or _axes(qs[0]) != b_axes:
        raise ValueError(f"q, kv and bias must shard the batch alike: "
                         f"{qs[0]}, {ks[0]}, {bs[0]}")
    # the entries that hold a distinct shard: every batch axis and the
    # sequence axis; one replica (index 0) of every other axis
    keep = [a for a in names if a in b_axes or a == seq_axis]
    grid = mesh.devices[tuple(slice(None) if a in keep else 0
                              for a in names)]
    grid = np.moveaxis(grid, keep.index(seq_axis), -1)
    n_seq = grid.shape[-1]
    grid = grid.reshape(-1, n_seq)                # (batch shards, S shards)
    b, s = q.shape[0], k.shape[2]
    if s % n_seq or b % grid.shape[0]:
        raise ValueError(f"S={s} and B={b} must divide the mesh's "
                         f"{n_seq} sequence and {grid.shape[0]} batch "
                         f"shards")
    bl, sl = b // grid.shape[0], s // n_seq
    outs = []
    for i, row in enumerate(grid):
        rows = slice(i * bl, (i + 1) * bl)
        stats = []
        for j, dev in enumerate(row):
            cols = slice(j * sl, (j + 1) * sl)
            m, l, acc = _decode_stats(
                q[rows].to(dev), k[rows, :, cols].to(dev),
                v[rows, :, cols].to(dev), bias[rows, cols].to(dev))
            stats.append((m.to(q.device), l.to(q.device),
                          acc.to(q.device)))
        m_g = stats[0][0]
        for m, _, _ in stats[1:]:
            m_g = torch.maximum(m_g, m)              # the pmax
        l_g, acc_g = 0, 0
        for m, l, acc in stats:                      # the two psums
            corr = torch.exp(m - m_g)
            l_g = l_g + l * corr
            acc_g = acc_g + acc * corr[..., None]
        outs.append(acc_g / torch.clamp(l_g, min=1e-30)[..., None])
    return torch.cat(outs).to(q.dtype)


def _rows(t: int, s: int, k0: int, k1: int, causal: bool,
          window: int | None) -> tuple[int, int]:
    """The query rows ``[r0, r1)`` that may attend some key of
    ``[k0, k1)`` (query r sits at position ``r + s - t``); the rest see
    none of them, so their P on the chunk is exactly 0."""
    off = s - t
    r0 = max(0, k0 - off) if causal else 0
    r1 = min(t, k1 - 1 + window - off) if window is not None else t
    return r0, max(r0, r1)


def _penalty(t: int, s: int, r0: int, r1: int, k0: int, k1: int,
             causal: bool, window: int | None, device) -> torch.Tensor:
    """(r1 - r0, k1 - k0) additive mask (0 = attend, ``NEG_INF`` =
    masked), as the JAX ``_penalty``."""
    qpos = torch.arange(r0, r1, device=device)[:, None] + (s - t)
    kpos = torch.arange(k0, k1, device=device)[None, :]
    pen = torch.zeros((r1 - r0, k1 - k0), dtype=torch.float32, device=device)
    if causal:
        pen.masked_fill_(kpos > qpos, NEG_INF)
    if window is not None:
        pen.masked_fill_(kpos <= qpos - window, NEG_INF)
    return pen


def _fwd_plain(q, k, v, causal: bool, window: int | None, kc: int):
    """The JAX ``_fwd``: an online softmax over key chunks of ``kc``, in
    float32.  Returns (out in q's type, (B, Hq, T) float32 LSE; a row
    with no key gets out 0 and :data:`EMPTY_LSE`)."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, t, d) * (1.0 / d ** 0.5)
    m = torch.full((b, hkv, g, t), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, t, d), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, s, kc):
        kj = k[:, :, k0:k0 + kc].float()
        vj = v[:, :, k0:k0 + kc].float()
        sc = torch.einsum("bkgtd,bksd->bkgts", qf, kj) + _penalty(
            t, s, 0, t, k0, k0 + kj.shape[2], causal, window, q.device)
        # the 0.8 * NEG_INF floor keeps exp() at exactly 0 on a chunk the
        # row cannot see, without a boolean mask
        m_new = torch.clamp(torch.maximum(m, sc.amax(-1)), min=0.8 * NEG_INF)
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgts,bksd->bkgtd", p,
                                                    vj)
        m = m_new
    seen = l > 0
    out = acc / torch.where(seen, l, 1.0)[..., None]
    lse = torch.where(seen, m + torch.log(torch.where(seen, l, 1.0)),
                      EMPTY_LSE)
    return out.reshape(b, hq, t, d).to(q.dtype), lse.reshape(b, hq, t)


def attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                  window: int | None = None, chunk: int = TRAIN_CHUNK):
    """The JAX ``_attn_bwd`` in plain torch: (dq, dk, dv) in the inputs'
    types from the forward's ``out`` and row ``lse``.

    Per key chunk, float32: P = exp(s - lse), dV = P^T dO, dP = dO V^T,
    dS = P (dP - delta) with delta = rowsum(dO * O), dQ += dS K and
    dK = dS^T Q, grouped over the GQA heads.  Only the query rows that
    can see the chunk take part (their P elsewhere is exactly 0, so the
    sums are the JAX ones without its zero terms).
    """
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / d ** 0.5
    kc = _pick_chunk(s, chunk)
    qf = q.float().reshape(b, hkv, g, t, d)
    dof = dout.float().reshape(b, hkv, g, t, d)
    lser = lse.reshape(b, hkv, g, t)
    delta = (dof * out.float().reshape(b, hkv, g, t, d)).sum(-1)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, hkv, s, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, s, kc):
        k1 = min(k0 + kc, s)
        r0, r1 = _rows(t, s, k0, k1, causal, window)
        if r0 == r1:
            continue                    # no row sees the chunk: all zeros
        kj = k[:, :, k0:k1].float()
        vj = v[:, :, k0:k1].float()
        qc, doc = qf[..., r0:r1, :], dof[..., r0:r1, :]
        sc = torch.einsum("bkgtd,bksd->bkgts", qc, kj).mul_(scale)
        sc.add_(_penalty(t, s, r0, r1, k0, k1, causal, window, q.device))
        p = sc.sub_(lser[..., r0:r1, None]).exp_()  # masked: exp(~NEG_INF)=0
        dv[:, :, k0:k1] = torch.einsum("bkgts,bkgtd->bksd", p, doc)
        ds = torch.einsum("bkgtd,bksd->bkgts", doc, vj)
        ds.sub_(delta[..., r0:r1, None]).mul_(p)             # d/d(score)
        del p
        dq[..., r0:r1, :] += torch.einsum("bkgts,bksd->bkgtd", ds, kj)
        dk[:, :, k0:k1] = torch.einsum("bkgts,bkgtd->bksd", ds, qc)
    return ((dq * scale).reshape(b, hq, t, d).to(q.dtype),
            (dk * scale).to(k.dtype), dv.to(v.dtype))


def lse_tolerance(s: int) -> float:
    """How far a kernel's float32 row LSE over ``s`` keys may lie from the
    exact one: l sums up to ``s`` float32 weights (a relative error of at
    most ``s`` units of 2^-24 if every addition rounds the same way), and
    each weight's exp2 and the final log2 add a few units more."""
    return (s + 16) * 2.0 ** -23


def bf16_grad_row_limits(q, k, v, dout, want, out, lse, *,
                         causal: bool = True, window: int | None = None,
                         steps: int = 2):
    """How far :func:`attention_bwd` fed the bf16 flash kernel's ``out``
    and ``lse`` may lie from ``want``, the (dq, dk, dv) of autograd
    through ``flash_attention_plain`` on the same bf16 inputs: a (dq, dk,
    dv) triple of per-row limits, (B, Hq, T, 1), (B, Hkv, S, 1) twice.

    Derived as ``bf16_row_limit`` is, term by term, from what the
    backward was fed.  Its P is exp(s - lse): row i's LSE off the exact
    one by e_i moves each P_ij by at most ``delta_i = expm1(|e_i|)`` of
    it.  Its ``D_i = dO_i . out_i`` is off the plain ``dO_i . O_i`` by
    ``|dO_i . (out_i - O_i)|``.  So dS = P (dP - D) moves by at most
    ``delta P |dP - D| + (1 + delta) P |dD|``, and dQ = scale dS K, dK =
    scale dS^T Q (summed over the group) and dV = P^T dO (``delta P
    |dO|``) by those sums of magnitudes; the float32 sums, in another
    order on each side, add 2^-16 of the sums of the terms' magnitudes
    (dP - D's too, where the two dot products cancel).
    Each side then rounds to bf16: ``steps`` bf16 steps at the row's
    largest ``|want|``.  Materializes (B, Hq, T, S) float32 tensors: call
    it on a slice of the batch.
    """
    from .ref import attention_mask
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / d ** 0.5
    qf, dof = q.float(), dout.float()
    kx = k.repeat_interleave(g, dim=1).float()
    vx = v.repeat_interleave(g, dim=1).float()
    mask = attention_mask(t, s, causal, window, q.device)
    logits = torch.einsum("bhtd,bhsd->bhts", qf, kx).mul_(scale) \
        .masked_fill_(~mask, float("-inf"))
    exact = torch.logsumexp(logits, dim=-1)                   # (B,Hq,T)
    p = torch.softmax(logits, dim=-1).nan_to_num_(0.0)
    del logits
    o = torch.einsum("bhts,bhsd->bhtd", p, vx)
    seen = mask.any(-1)
    delta = torch.where(seen, torch.expm1((lse.float() - exact).abs()),
                        0.0)[..., None]
    d_d = (dof * (out.float() - o)).sum(-1, keepdim=True).abs_()
    dp = torch.einsum("bhtd,bhsd->bhts", dof, vx)
    dp.sub_((dof * o).sum(-1, keepdim=True))                  # dP - D
    rho = 2.0 ** -16
    ds_abs = (p * dp).abs_()                                  # |dS|
    dds = dp.abs_().mul_(p).mul_(delta).add_(p * (d_d * (1 + delta)))
    del dp
    # dP - D itself: two float32 dot products over D, summed in another
    # order on each side, where they cancel
    dds.add_(p * rho * (torch.einsum("bhtd,bhsd->bhts", dof.abs(), vx.abs())
                        + (dof * o).abs().sum(-1, keepdim=True)))
    ka, qa = kx.abs_(), qf.abs()
    lim_q = scale * (torch.einsum("bhts,bhsd->bhtd", dds, ka) +
                     rho * torch.einsum("bhts,bhsd->bhtd", ds_abs, ka))
    lim_k = scale * (torch.einsum("bhts,bhtd->bhsd", dds, qa) +
                     rho * torch.einsum("bhts,bhtd->bhsd", ds_abs, qa))
    lim_v = torch.einsum("bhts,bhtd->bhsd", p * (delta + rho), dof.abs())
    del dds, ds_abs, p

    def rows(lim, w, group):
        if group:
            lim = lim.reshape(b, hkv, g, s, d).sum(2)
        peak = w.float().abs().amax(dim=-1, keepdim=True)
        return lim.amax(dim=-1, keepdim=True) + \
            steps * torch.exp2(torch.floor(torch.log2(peak)) - 7)
    return (rows(lim_q, want[0], False), rows(lim_k, want[1], True),
            rows(lim_v, want[2], True))


class _Attention(torch.autograd.Function):
    """GQA attention with the hand-written backward: the flash kernel's
    forward (with its LSE) on CUDA (its meta op on ``meta``), the plain
    chunked one on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        if q.device.type == "cpu":
            out, lse = _fwd_plain(q, k, v, causal, window,
                                  _pick_chunk(k.shape[2], chunk))
        else:                           # the kernel (its meta op: dry run)
            out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, chunk = ctx.args
        dq, dk, dv = attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   window=window, chunk=chunk)
        return dq, dk, dv, None, None, None


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      chunk: int = TRAIN_CHUNK) -> torch.Tensor:
    """GQA attention that autograd can differentiate.  q: (B, Hq, T, D);
    k, v: (B, Hkv, S, D) -> (B, Hq, T, D) in q's type, scores scaled by
    ``1 / sqrt(D)``, queries on the last T of S positions.

    When a gradient is needed, the :class:`_Attention` Function; else the
    flash wrapper alone (the serve path: the kernel on CUDA, its plain
    version on the CPU)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, window, chunk)
    return flash_attention(q, k, v, causal=causal, window=window)
