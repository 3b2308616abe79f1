"""Layer blocks of every family.

The port's copy of ``repro/models/blocks.py``: GQA attention (rope or
learned positions, ``qkv_bias``, ``qk_norm``, causal and global or
windowed, or cross-attention over an encoder's K/V) with its prefill
and decode paths, the gated MLP, the dropless top-k MoE (its ``ragged``
path and the expert-parallel ``shard_map`` one), the RG-LRU recurrent
block with its causal conv, and the mamba2 SSD mixer (chunked
state-space duality, its inter-chunk recurrence on ``linear_scan``).
Each block is a :class:`~.common.SpecModule` whose parameters carry the
JAX names (``wq``, ``w_gate``, ``router``, ``lam``, ``w_in`` ...);
norms, rope and the conv are plain functions on tensors.

Every mixer has two modes: prefill (full sequence, optionally emitting
the decode cache) and decode (one token against the cache).  Decode
updates the attention cache in place -- the KV buffer is the largest
state of a step and is never copied -- and returns it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.chunked_attention import NEG_INF, decode_attention
from .common import SpecModule, TSpec, rms_norm, rope, torch_dtype

# position of an empty cache slot: never <= a query position
EMPTY_POS = (2**31 - 1) // 2


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call context: the config, the decode cache's length and the
    MoE implementation (``ragged``: dropless, one device; ``shard_map``:
    expert-parallel over ``mesh``'s ``model`` axis with a static
    per-expert capacity of ``moe_capacity_factor`` times the even
    share)."""
    cfg: object
    cache_len: int = 0
    moe_impl: str = "ragged"
    mesh: object = None
    moe_capacity_factor: float = 1.25


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

    def project(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """One projection of x (B, T, D): ``name`` "q" -> (B, T, H, hd),
        "k" or "v" -> (B, T, Hkv, hd), with its bias and (q, k) norm."""
        cfg = self.cfg
        y = x @ getattr(self, "w" + name).to(x.dtype)
        if cfg.qkv_bias:
            y = y + getattr(self, "b" + name).to(x.dtype)
        heads = cfg.n_heads if name == "q" else cfg.n_kv_heads
        y = y.reshape(*x.shape[:2], heads, cfg.resolved_head_dim)
        if cfg.qk_norm and name != "v":
            y = rms_norm(y, getattr(self, name + "_norm"))
        return y

    def encoder_kv(self, enc_out: torch.Tensor) -> dict:
        """The cross-attention K/V of an encoder's output (B, S, D), each
        (B, Hkv, S, hd), no rope (the JAX ``_encoder_kv``); no Q."""
        h = rms_norm(enc_out, self.ln)
        return {n: self.project(h, n).transpose(1, 2).contiguous()
                for n in ("k", "v")}

    def forward(self, ctx: Ctx, x: torch.Tensor, positions: torch.Tensor, *,
                causal: bool = True, window: int | None = None,
                cache: dict | None = None, return_cache: bool = False,
                kv_override: dict | None = None):
        """Returns (out, new_cache).  x: (B, T, D); positions: (B, T).
        ``kv_override`` (cross-attention): :meth:`encoder_kv`'s K/V,
        attended without a mask in place of this x's own k and v."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.resolved_head_dim
        q = self.project(x, "q")
        if kv_override is not None:                         # no own K/V
            if cfg.rope_theta > 0:
                q = rope(q, positions, cfg.rope_theta)
            out = kops.attention(q.transpose(1, 2).contiguous(),
                                 kv_override["k"], kv_override["v"],
                                 causal=False)
            out = out.transpose(1, 2).reshape(b, t, cfg.n_heads * hd)
            return out @ self.wo.to(x.dtype), None
        k, v = self.project(x, "k"), self.project(x, "v")
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
            out = kops.attention(qh, kh, vh, causal=causal, window=window)
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


def gated_ffn(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """silu(x W_gate) * (x W_up) W_down in x's dtype: the MLP, one
    expert on its rows (m, d), or a batch of experts on (e, c, d) with
    (e, d, f) weights."""
    h = F.silu(x @ w_gate.to(x.dtype)) * (x @ w_up.to(x.dtype))
    return h @ w_down.to(x.dtype)


class MLP(SpecModule):
    def __init__(self, cfg, device):
        super().__init__(mlp_specs(cfg), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gated_ffn(x, self.w_gate, self.w_up, self.w_down)


# ---------------------------------------------------------------------------
# dropless MoE (top-k router + per-expert GEMMs)
# ---------------------------------------------------------------------------

def moe_specs(cfg) -> dict[str, TSpec]:
    d, pd = cfg.d_model, cfg.param_dtype
    e, f = cfg.n_experts, (cfg.moe_d_ff or cfg.d_ff)
    return {
        "router": TSpec((d, e), "float32"),
        "w_gate": TSpec((e, d, f), pd),
        "w_up": TSpec((e, d, f), pd),
        "w_down": TSpec((e, f, d), pd, init="scaled"),
        "ln": TSpec((d,), "float32", init="zeros"),
    }


def router(cfg, w_router: torch.Tensor, xf: torch.Tensor):
    """(top weights (n, k), top experts (n, k), aux): float32 logits and
    softmax, top-k by probability (``sorted``, as ``jax.lax.top_k``), the
    k weights renormalised, and the Switch-style load-balance loss."""
    e, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(xf.float() @ w_router.float(), dim=-1)
    topw, tope = torch.topk(probs, k, dim=-1, sorted=True)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    density = F.one_hot(tope, e).float().mean(dim=(0, 1))
    aux = e * torch.sum(density * probs.mean(dim=0))
    return topw, tope, aux


def _combine(ys: torch.Tensor, order: torch.Tensor, w: torch.Tensor,
             n: int, k: int) -> torch.Tensor:
    """The (n, d) output of the expert-sorted rows ``ys`` (slot ``i`` of
    ``ys`` is flat slot ``order[i]``, token ``order[i] // k``): each
    weighted by its routing weight ``w`` (n * k,) and summed over the
    token's k slots in slot order.  A gather and a sum, no atomics, so
    the result does not vary from run to run."""
    flat = torch.empty_like(ys)
    flat[order] = ys
    flat = flat * w[:, None].to(ys.dtype)
    return flat.view(n, k, -1).sum(dim=1)


# At most this many tokens, the dropless MoE runs every expert on every
# token as batched (E, n, d) products.  That reads every expert's weights
# where top-k needs only the active ones (at batch 1, 64 experts where
# moonshot-v1-16b-a3b's top-6 needs 6: ~10.7x the bytes, ~16 ms a step at
# HBM rate on an H100), so it trades weight bytes for host work: ~10
# launches a layer instead of ~6 per active expert and a read of the
# group sizes.  A decode step of moonshot at batch 8 took 285 ms the
# per-expert way on an H100, 86% of it idle device, and 134.7 ms this way
# (PERF.md §6); once the step is no longer host-bound (a CUDA graph, a
# grouped-GEMM kernel) this route costs more than it saves
MOE_DENSE_TOKENS = 64


def moe_ragged(cfg, p, x: torch.Tensor):
    """Dropless top-k MoE (the JAX ``ragged`` path, whose grouped GEMM is
    ``jax.lax.ragged_dot``).  Above :data:`MOE_DENSE_TOKENS` tokens: the
    (token, expert) slots sorted by expert (stable, as ``jnp.argsort``),
    the group sizes read to the host once, one gated FFN per non-empty
    expert on its contiguous rows; at or below it, every expert on
    every token and each token's k outputs picked.  Returns ((B, T, D)
    out, aux)."""
    b, t, d = x.shape
    k = cfg.experts_per_token
    n = b * t
    xf = x.reshape(n, d)
    topw, tope, aux = router(cfg, p.router, xf)
    if n <= MOE_DENSE_TOKENS:
        ye = gated_ffn(xf.expand(cfg.n_experts, n, d), p.w_gate, p.w_up,
                       p.w_down)                           # (E, n, d)
        ys = ye[tope, torch.arange(n, device=x.device)[:, None]]
        out = (ys * topw[..., None].to(ys.dtype)).sum(dim=1)
        return out.reshape(b, t, d), aux
    flat_e = tope.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    xs = xf[order // k]                                    # expert-sorted
    sizes = torch.bincount(flat_e, minlength=cfg.n_experts).tolist()
    ys = torch.empty_like(xs)
    lo = 0
    for i, m in enumerate(sizes):
        if m:
            ys[lo:lo + m] = gated_ffn(xs[lo:lo + m], p.w_gate[i],
                                      p.w_up[i], p.w_down[i])
            lo += m
    out = _combine(ys, order, topw.reshape(-1), n, k)
    return out.reshape(b, t, d), aux


def moe_local_experts(xf, topw, tope, w_gate, w_up, w_down, e_lo: int,
                      capacity: int) -> torch.Tensor:
    """One model-axis entry's experts ``[e_lo, e_lo + e_local)`` over all
    of its tokens, at a static ``capacity`` rows per expert (the JAX
    ``_moe_local_experts``): a slot past its expert's capacity, or of a
    foreign expert, is dropped.  Returns the (n, d) partial output."""
    n, d = xf.shape
    k = tope.shape[1]
    e_local = w_gate.shape[0]
    rel = tope.reshape(-1) - e_lo
    mine = (rel >= 0) & (rel < e_local)
    key = torch.where(mine, rel, e_local)                  # foreign last
    order = torch.argsort(key, stable=True)
    sorted_rel = key[order]
    starts = torch.searchsorted(sorted_rel, torch.arange(
        e_local, device=xf.device, dtype=sorted_rel.dtype))
    pos = torch.arange(n * k, device=xf.device) - \
        starts[sorted_rel.clamp(max=e_local - 1)]
    keep = (sorted_rel < e_local) & (pos < capacity)
    src = torch.where(keep[:, None], xf[order // k], 0).to(xf.dtype)
    slot_e = torch.where(keep, sorted_rel, 0)
    slot_c = torch.where(keep, pos, 0)
    # kept slots are distinct; the dropped ones add zeros at (0, 0)
    xe = torch.zeros((e_local, capacity, d), dtype=xf.dtype,
                     device=xf.device).index_put_((slot_e, slot_c), src,
                                                  accumulate=True)
    ye = gated_ffn(xe, w_gate, w_up, w_down)               # (e, c, d)
    ys = ye[slot_e, slot_c] * keep[:, None]
    return _combine(ys, order, topw.reshape(-1), n, k)


def moe_shard_map(ctx: Ctx, p, x: torch.Tensor):
    """Expert parallelism over ``ctx.mesh`` (the JAX ``_moe_shard_map``),
    single-controller: the batch is split over the mesh's other axes
    when it divides them (else each takes all of it), each ``model``
    entry runs its ``e / TP`` local experts on its entry's device with
    the static capacity, and the sum over the entries stands in for
    the ``psum``; ``aux`` is the mean over the batch shards."""
    cfg = ctx.cfg
    mesh = ctx.mesh
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    names = list(mesh.axis_names)
    tp = mesh.devices.shape[names.index("model")]
    if e % tp:
        raise ValueError(f"experts {e} must divide the model axis {tp}")
    e_local = e // tp
    grid = np.moveaxis(mesh.devices, names.index("model"), -1).reshape(-1, tp)
    n_dp = grid.shape[0]
    shards = n_dp if b % n_dp == 0 else 1      # else every entry: all of it
    b_local = b // shards
    capacity = max(1, math.ceil(b_local * t * k * ctx.moe_capacity_factor
                                / e))
    outs, auxes = [], []
    for i in range(shards):
        xb = x[i * b_local:(i + 1) * b_local]
        xf = xb.reshape(-1, d)
        total = None
        for j, dev in enumerate(grid[i]):
            xj = xf.to(dev)
            topw, tope, aux = router(cfg, p.router.to(dev), xj)
            sl = slice(j * e_local, (j + 1) * e_local)
            part = moe_local_experts(
                xj, topw, tope, p.w_gate[sl].to(dev), p.w_up[sl].to(dev),
                p.w_down[sl].to(dev), j * e_local, capacity).to(x.device)
            total = part if total is None else total + part
        outs.append(total.reshape(xb.shape))
        auxes.append(aux.to(x.device))
    return torch.cat(outs), torch.stack(auxes).mean()


class MoE(SpecModule):
    def __init__(self, cfg, device):
        super().__init__(moe_specs(cfg), device)
        self.cfg = cfg

    def forward(self, ctx: Ctx, x: torch.Tensor):
        """Returns (out, aux)."""
        if ctx.moe_impl == "ragged":
            return moe_ragged(self.cfg, self, x)
        if ctx.moe_impl == "shard_map":
            if ctx.mesh is None:
                raise ValueError('moe_impl="shard_map" needs ctx.mesh')
            return moe_shard_map(ctx, self, x)
        raise ValueError(f"unknown moe_impl {ctx.moe_impl!r}")


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
