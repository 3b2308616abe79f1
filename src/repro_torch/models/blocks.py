"""Layer blocks of the hybrid, dense and SSM stacks.

The port's copy of the parts of ``repro/models/blocks.py`` that the
hybrid (recurrentgemma), dense (qwen2, llama, qwen3) and SSM (mamba2)
families need: GQA attention (rope, ``qkv_bias``, ``qk_norm``, causal
and global or windowed) with its prefill and decode paths, the gated
MLP, the RG-LRU recurrent block with its causal conv, and the mamba2
SSD mixer (chunked state-space duality, its inter-chunk recurrence on
``linear_scan``).  Each block is a :class:`~.common.SpecModule` whose
parameters carry the JAX names (``wq``, ``w_gate``, ``lam``, ``w_in``
...); norms, rope and the conv are plain functions on tensors.  MoE
waits for a later slice.

Every mixer has two modes: prefill (full sequence, optionally emitting
the decode cache) and decode (one token against the cache).  Decode
updates the attention cache in place -- the KV buffer is the largest
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


def attn_cache_specs(cfg, batch: int, cache_len: int, dtype: str,
                     window: int | None = None) -> dict[str, TSpec]:
    """The decode cache :func:`attn_prefill_cache` builds: a global layer
    keeps ``cache_len`` slots, a windowed one ``min(cache_len, window)``."""
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    s = min(cache_len, window) if window else cache_len
    return {"k": TSpec((batch, kv, s, hd), dtype, init="zeros"),
            "v": TSpec((batch, kv, s, hd), dtype, init="zeros"),
            "pos": TSpec((batch, s), "int32", init="zeros")}


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


def rglru_cache_specs(cfg, batch: int) -> dict[str, TSpec]:
    w = cfg.rglru_width or cfg.d_model
    return {"state": TSpec((batch, w), "float32", init="zeros"),
            "conv": TSpec((batch, cfg.conv_width - 1, w), "float32",
                          init="zeros")}


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


# ---------------------------------------------------------------------------
# mamba2 SSD (chunked state-space duality)
# ---------------------------------------------------------------------------

def ssd_specs(cfg) -> dict[str, TSpec]:
    d, pd = cfg.d_model, cfg.param_dtype
    di, ns, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "w_in": TSpec((d, 2 * di + 2 * ns + h), pd),
        "conv": TSpec((cfg.conv_width, di + 2 * ns), "float32"),
        "dt_bias": TSpec((h,), "float32", init="zeros"),
        "a_log": TSpec((h,), "float32", init="zeros"),
        "d_skip": TSpec((h,), "float32", init="zeros"),
        "norm": TSpec((di,), "float32", init="zeros"),
        "w_out": TSpec((di, d), pd, init="scaled"),
        "ln": TSpec((d,), "float32", init="zeros"),
    }


def ssd_cache_specs(cfg, batch: int) -> dict[str, TSpec]:
    """The decode cache: the (H, N, P) state per request in float32, and
    the conv's last W-1 inputs (the prefill leaves them in the model's
    type, as the JAX package does)."""
    di, ns = cfg.d_inner, cfg.ssm_state
    return {"state": TSpec((batch, cfg.ssm_heads, ns, cfg.ssm_head_dim),
                           "float32", init="zeros"),
            "conv": TSpec((batch, cfg.conv_width - 1, di + 2 * ns),
                          "float32", init="zeros")}


def ssd_split(cfg, zxbcdt: torch.Tensor):
    """(z, x, B, C, dt) of the fused input projection."""
    di, ns = cfg.d_inner, cfg.ssm_state
    return torch.split(zxbcdt, [di, di, ns, ns, cfg.ssm_heads], dim=-1)


def ssd_chunked(cfg, x: torch.Tensor, da: torch.Tensor, bb: torch.Tensor,
                cc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: intra-chunk quadratic + inter-chunk linear scan.

    x: (B, T, H, P) float32 (already dt-scaled); da: (B, T, H) log-decay;
    bb, cc: (B, T, N).  Returns (y (B, T, H, P), last state (B, H, N, P)).
    A T that is not a multiple of the chunk is padded with no-op steps
    (x = 0: no state update; da = 0: decay 1).  The recurrence over the
    chunks runs on ``linear_scan`` at (B*H, n_chunks, N*P); the
    intra-chunk products are plain torch, as they are plain XLA in the
    JAX package.
    """
    b, t, h, hp = x.shape
    ns = bb.shape[-1]
    lc = min(cfg.ssm_chunk, t)
    t_orig = t
    if t % lc:
        pad = lc - t % lc
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        bb = F.pad(bb, (0, 0, 0, pad))
        cc = F.pad(cc, (0, 0, 0, pad))
        t += pad
    nc = t // lc
    xr = x.reshape(b, nc, lc, h, hp)
    br = bb.reshape(b, nc, lc, ns)
    cr = cc.reshape(b, nc, lc, ns)
    cs = torch.cumsum(da.reshape(b, nc, lc, h), dim=2)     # (B,nc,Lc,H)

    # intra-chunk: y[l] += sum_{s<=l} exp(cs[l]-cs[s]) (C_l.B_s) x_s.  The
    # (B, nc, Lc, Lc, H) decay is the largest tensor of the layer: it is
    # built once and weighted in place
    gb = torch.einsum("bcln,bcsn->bcls", cr, br)           # (B,nc,Lc,Lc)
    decay = (cs[:, :, :, None, :] - cs[:, :, None, :, :]).exp_()
    upper = ~torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                   device=x.device))
    decay.masked_fill_(upper[None, None, :, :, None], 0.0)
    decay.mul_(gb[..., None])
    y = torch.einsum("bclsh,bcshp->bclhp", decay, xr)
    del decay, gb

    # chunk states: S_c = sum_s exp(cs_last - cs_s) B_s (x) x_s
    seg = torch.exp(cs[:, :, -1:, :] - cs)                 # (B,nc,Lc,H)
    states = torch.einsum("bcsn,bcshp->bchnp", br, xr * seg[..., None])

    # the recurrence over chunks: the chunk decay repeated over N*P
    chunk_decay = torch.exp(cs[:, :, -1, :])               # (B,nc,H)
    a_flat = chunk_decay.permute(0, 2, 1).reshape(b * h, nc, 1).expand(
        b * h, nc, ns * hp).contiguous()
    s_flat = states.permute(0, 2, 1, 3, 4).reshape(
        b * h, nc, ns * hp).contiguous()
    all_states, last = kops.linear_scan(s_flat, a_flat)
    # the states *entering* each chunk: shifted right by one
    prev = torch.cat([torch.zeros_like(all_states[:, :1]),
                      all_states[:, :-1]], dim=1)
    prev = prev.reshape(b, h, nc, ns, hp).permute(0, 2, 1, 3, 4)

    # inter-chunk contribution: C_l . exp(cs_l) S_prev
    y_off = torch.einsum("bcln,bchnp->bclhp", cr, prev) * \
        torch.exp(cs)[..., None]
    y = (y + y_off).reshape(b, t, h, hp)[:, :t_orig]
    return y, last.reshape(b, h, ns, hp)


class SSD(SpecModule):
    """The mamba2 mixer: fused in-projection, causal conv over (x, B, C),
    the SSD recurrence, a per-head skip, a gated RMS norm."""

    def __init__(self, cfg, device):
        super().__init__(ssd_specs(cfg), device)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, *, cache: dict | None = None,
                return_cache: bool = False):
        """Returns (out, new_cache).  With ``cache`` (decode) T must be 1:
        the state advances one step, in plain torch."""
        cfg = self.cfg
        b, t, _ = x.shape
        di, ns = cfg.d_inner, cfg.ssm_state
        h, hp = cfg.ssm_heads, cfg.ssm_head_dim
        if cache is not None and t != 1:
            raise ValueError(f"SSD decode takes one token, got T={t}")
        z, xin, bb, cc, dt = ssd_split(cfg, x @ self.w_in.to(x.dtype))
        conv_out, new_conv = causal_conv(
            torch.cat([xin, bb, cc], dim=-1), self.conv,
            cache["conv"] if cache is not None else None)
        conv_out = F.silu(conv_out)
        xin = conv_out[..., :di].reshape(b, t, h, hp)
        bb = conv_out[..., di:di + ns].float()
        cc = conv_out[..., di + ns:].float()
        dt = F.softplus(dt.float() + self.dt_bias)             # (B,T,H)
        da = dt * -torch.exp(self.a_log)                       # log decay
        xdt = xin.float() * dt[..., None]
        if cache is not None:                                  # one step
            upd = torch.einsum("bn,bhp->bhnp", bb[:, 0], xdt[:, 0])
            state = torch.exp(da[:, 0])[..., None, None] * cache["state"] \
                + upd
            y = torch.einsum("bn,bhnp->bhp", cc[:, 0], state)[:, None]
            new_cache = {"state": state, "conv": new_conv}
        else:
            y, last = ssd_chunked(cfg, xdt, da, bb, cc)
            new_cache = ({"state": last, "conv": new_conv}
                         if return_cache else None)
        y = y + xdt * self.d_skip[..., None]                  # per-head skip
        y = y.reshape(b, t, di).to(x.dtype)
        y = rms_norm(y, self.norm) * F.silu(z)
        return y @ self.w_out.to(x.dtype), new_cache
