"""Layer blocks of the hybrid (RG-LRU + local attention) stack.

The port's copy of the parts of ``repro/models/blocks.py`` that
recurrentgemma needs: GQA attention (rope, ``qkv_bias``, ``qk_norm``,
causal with an optional window) with its prefill and ring-buffer decode
paths, the gated MLP, and the RG-LRU recurrent block with its causal
conv.  Each block is a :class:`~.common.SpecModule` whose parameters
carry the JAX names (``wq``, ``w_gate``, ``lam`` ...); norms, rope and
the conv are plain functions on tensors.  MoE and SSD wait for a later
slice.

Every mixer has two modes: prefill (full sequence, optionally emitting
the decode cache) and decode (one token against the cache).  Decode
updates the attention cache in place -- the ring buffer is the largest
state of a step and is never copied -- and returns it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.chunked_attention import NEG_INF, decode_attention
from .common import SpecModule, TSpec, rms_norm, rope, torch_dtype

# position of an empty cache slot: never <= a query position
EMPTY_POS = (2**31 - 1) // 2


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call context: the config and the decode cache's length."""
    cfg: object
    cache_len: int = 0


# ---------------------------------------------------------------------------
# attention (global + local window), GQA, rope
# ---------------------------------------------------------------------------

def attn_specs(cfg) -> dict[str, TSpec]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    pd = cfg.param_dtype
    p = {
        "wq": TSpec((d, h * hd), pd),
        "wk": TSpec((d, kv * hd), pd),
        "wv": TSpec((d, kv * hd), pd),
        "wo": TSpec((h * hd, d), pd, init="scaled"),
        "ln": TSpec((d,), "float32", init="zeros"),
    }
    if cfg.qkv_bias:
        p["bq"] = TSpec((h * hd,), "float32", init="zeros")
        p["bk"] = TSpec((kv * hd,), "float32", init="zeros")
        p["bv"] = TSpec((kv * hd,), "float32", init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = TSpec((hd,), "float32", init="zeros")
        p["k_norm"] = TSpec((hd,), "float32", init="zeros")
    return p


def attn_prefill_cache(k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor, cache_len: int,
                       window: int | None, dtype: torch.dtype) -> dict:
    """The decode cache from prefill K/V.  k, v: (B, T, Hkv, hd).

    A window-sized ring buffer keeps position p in slot ``p % s``, the
    slot decode writes (the JAX ``attn_prefill_cache`` keeps the last s
    positions in order, so for T > s with T % s != 0 the first decode
    step overwrites a key still inside the window).  Unused slots hold
    zeros at position :data:`EMPTY_POS`.
    """
    b, t, hkv, hd = k.shape
    s = min(cache_len, window) if window else cache_len
    kh = k.transpose(1, 2).to(dtype)
    vh = v.transpose(1, 2).to(dtype)
    ck = torch.zeros((b, hkv, s, hd), dtype=dtype, device=k.device)
    cv = torch.zeros_like(ck)
    cpos = torch.full((b, s), EMPTY_POS, dtype=torch.int32, device=k.device)
    first = max(t - s, 0)
    keep = torch.arange(first, t, device=k.device)
    slots = keep % s if window else keep - first
    ck[:, :, slots] = kh[:, :, first:]
    cv[:, :, slots] = vh[:, :, first:]
    cpos[:, slots] = positions[:, first:].to(torch.int32)
    return {"k": ck, "v": cv, "pos": cpos}


class Attention(SpecModule):
    def __init__(self, cfg, device):
        super().__init__(attn_specs(cfg), device)
        self.cfg = cfg

    def project_qkv(self, x: torch.Tensor):
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.resolved_head_dim
        q = x @ self.wq.to(x.dtype)
        k = x @ self.wk.to(x.dtype)
        v = x @ self.wv.to(x.dtype)
        if cfg.qkv_bias:
            q = q + self.bq.to(x.dtype)
            k = k + self.bk.to(x.dtype)
            v = v + self.bv.to(x.dtype)
        q = q.reshape(b, t, cfg.n_heads, hd)
        k = k.reshape(b, t, cfg.n_kv_heads, hd)
        v = v.reshape(b, t, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm)
            k = rms_norm(k, self.k_norm)
        return q, k, v

    def forward(self, ctx: Ctx, x: torch.Tensor, positions: torch.Tensor, *,
                window: int | None = None, cache: dict | None = None,
                return_cache: bool = False):
        """Returns (out, new_cache).  x: (B, T, D); positions: (B, T)."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.resolved_head_dim
        q, k, v = self.project_qkv(x)
        if cfg.rope_theta > 0:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        qh = q.transpose(1, 2).contiguous()                 # (B, H, T, hd)
        new_cache = None
        if cache is not None:                               # decode: T == 1
            ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
            s = ck.shape[2]
            pos = positions[:, -1].to(torch.int32)
            slot = (pos % s) if window else torch.clamp(pos, max=s - 1)
            bidx = torch.arange(b, device=x.device)
            ck[bidx, :, slot] = k[:, 0].to(ck.dtype)
            cv[bidx, :, slot] = v[:, 0].to(cv.dtype)
            cpos[bidx, slot] = pos
            new_cache = cache
            qpos = pos[:, None]
            valid = cpos <= qpos                              # causal
            if window:
                valid &= cpos > qpos - window
            group = cfg.n_heads // cfg.n_kv_heads
            qg = qh[:, :, 0].reshape(b, cfg.n_kv_heads, group, hd)
            bias = torch.where(valid, 0.0, NEG_INF)           # (B, S)
            o = decode_attention(qg, ck, cv, bias)
            out = o.reshape(b, cfg.n_heads, 1, hd).to(x.dtype)
        else:                                               # prefill
            kh = k.transpose(1, 2).contiguous()
            vh = v.transpose(1, 2).contiguous()
            out = kops.attention(qh, kh, vh, causal=True, window=window)
            if return_cache:
                new_cache = attn_prefill_cache(k, v, positions,
                                               ctx.cache_len, window,
                                               torch_dtype(cfg.dtype))
        out = out.transpose(1, 2).reshape(b, t, cfg.n_heads * hd)
        return out @ self.wo.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# dense gated FFN
# ---------------------------------------------------------------------------

def mlp_specs(cfg) -> dict[str, TSpec]:
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {
        "w_gate": TSpec((d, f), pd),
        "w_up": TSpec((d, f), pd),
        "w_down": TSpec((f, d), pd, init="scaled"),
        "ln": TSpec((d,), "float32", init="zeros"),
    }


class MLP(SpecModule):
    def __init__(self, cfg, device):
        super().__init__(mlp_specs(cfg), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(x @ self.w_gate.to(x.dtype))
        h = h * (x @ self.w_up.to(x.dtype))
        return h @ self.w_down.to(x.dtype)


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma) recurrent block
# ---------------------------------------------------------------------------

def rglru_specs(cfg) -> dict[str, TSpec]:
    d, pd = cfg.d_model, cfg.param_dtype
    w = cfg.rglru_width or d
    return {
        "w_x": TSpec((d, w), pd),
        "w_y": TSpec((d, w), pd),
        "conv": TSpec((cfg.conv_width, w), "float32"),
        "w_a": TSpec((w, w), pd),
        "w_i": TSpec((w, w), pd),
        "lam": TSpec((w,), "float32", init="ones"),
        "w_out": TSpec((w, d), pd, init="scaled"),
        "ln": TSpec((d,), "float32", init="zeros"),
    }


def causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                state: torch.Tensor | None = None):
    """Depthwise causal conv.  x: (B, T, C); kernel: (W, C); ``state``:
    (B, W-1, C) tail of the previous segment (decode).  The taps are
    summed in x's dtype, in tap order, as the reference does.  Returns
    (out, new_state)."""
    w, t = kernel.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, w - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = xp[:, 0:t] * kernel[0].to(x.dtype)
    for i in range(1, w):
        out = out + xp[:, i:i + t] * kernel[i].to(x.dtype)
    new_state = xp[:, -(w - 1):].clone() if w > 1 else None
    return out, new_state


class RGLRU(SpecModule):
    """Griffin recurrent block: conv -> RG-LRU, gated by a GeLU branch."""

    def __init__(self, cfg, device):
        super().__init__(rglru_specs(cfg), device)

    def forward(self, x: torch.Tensor, *, cache: dict | None = None,
                return_cache: bool = False):
        u = x @ self.w_x.to(x.dtype)
        g = F.gelu(x @ self.w_y.to(x.dtype), approximate="tanh")
        u, new_conv = causal_conv(u, self.conv,
                                  cache["conv"] if cache is not None else None)
        uf = u.float()                   # the gates run in float32
        r = torch.sigmoid(uf @ self.w_a.float())
        i = torch.sigmoid(uf @ self.w_i.float())
        log_a = (-8.0 * F.softplus(self.lam)) * r
        a = torch.exp(log_a)
        gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
        h0 = cache["state"] if cache is not None else None
        hs, last = kops.linear_scan(gated, a, h0)
        y = hs.to(x.dtype) * g
        out = y @ self.w_out.to(x.dtype)
        new_cache = ({"state": last, "conv": new_conv}
                     if (cache is not None or return_cache) else None)
        return out, new_cache
