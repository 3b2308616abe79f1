"""LM assembly: decoder-only, encoder-decoder (whisper) and VLM backbones.

The port's copy of ``repro/models/lm.py``: one :class:`Layer` per entry
of ``cfg.pattern`` (``local``/``attn`` -> attention, then a cross-
attention over the encoder's K/V in an encoder-decoder, then an MLP or,
where ``cfg.n_experts`` is set, an MoE; ``rglru`` -> RG-LRU + MLP;
``ssd`` -> the mamba2 mixer alone), learned positions where
``rope_theta == 0``, the whisper encoder (non-causal attention + MLP
over the frontend's frame embeddings), and the vision stub's projection
of patch embeddings placed before the text.  Two entry points --
:meth:`LM.prefill` (builds the decode cache; ``frontend_embeds`` for
the stubs) and :meth:`LM.decode_step` (one token) -- and caches as a
per-layer list of dicts whose tensors all have batch on axis 0; an
encoder-decoder's cross-attention K/V sits in each layer's dict under
``xattn``, computed once in prefill and only read by decode.  The JAX
package scans a homogeneous stack over a layer-stacked param tree and
unrolls a heterogeneous one; here both are an ``nn.ModuleList`` of
layers, named ``layers.<i>.<block>.<name>`` (``encoder.layers.<i>...``
for the encoder; ``convert.lm_params_from_jax`` unstacks the JAX tree).
The MoE's ``aux`` loss is dropped by both entry points, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..kernels.ops import resolve_device
from . import blocks
from .blocks import Ctx
from .common import SpecModule, TSpec, init_from_specs, rms_norm, torch_dtype

MAX_LEARNED_POS = 32_768     # whisper-style learned positions

_BLOCKS = {"attn": (blocks.Attention, blocks.attn_specs),
           "xattn": (blocks.Attention, blocks.attn_specs),
           "mlp": (blocks.MLP, blocks.mlp_specs),
           "moe": (blocks.MoE, blocks.moe_specs),
           "rglru": (blocks.RGLRU, blocks.rglru_specs),
           "ssd": (blocks.SSD, blocks.ssd_specs)}
_KINDS = ("attn", "local", "rglru", "ssd")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a layer kind no block runs."""
    unknown = sorted(set(cfg.pattern) - set(_KINDS))
    if unknown:
        raise NotImplementedError(f"{cfg.name}: layer kinds {unknown} are "
                                  f"not among {_KINDS}")


def _layer_blocks(cfg, kind: str) -> tuple[str, ...]:
    """A layer's blocks, mixer first (the JAX ``_layer_specs``; the
    cross-attention of a homogeneous encoder-decoder, ``lm.py:113``)."""
    if kind in ("attn", "local"):
        xattn = ("xattn",) if cfg.encoder_layers and cfg.homogeneous else ()
        return ("attn", *xattn, "moe" if cfg.n_experts else "mlp")
    if kind == "rglru":
        return ("rglru", "mlp")
    return ("ssd",)


def _layer_specs(cfg, kind: str) -> dict[str, dict[str, TSpec]]:
    return {blk: _BLOCKS[blk][1](cfg) for blk in _layer_blocks(cfg, kind)}


def _layer_cache_specs(cfg, kind: str, batch: int,
                       cache_len: int) -> dict[str, dict[str, TSpec]]:
    if kind in ("attn", "local"):
        c = {"attn": blocks.attn_cache_specs(
            cfg, batch, cache_len, cfg.dtype,
            window=cfg.window if kind == "local" else None)}
        if "xattn" in _layer_blocks(cfg, kind):
            kv = TSpec((batch, cfg.n_kv_heads, cfg.frontend_tokens,
                        cfg.resolved_head_dim), cfg.dtype, init="zeros")
            c["xattn"] = {"k": kv, "v": kv}
        return c
    if kind == "ssd":
        return {"ssd": blocks.ssd_cache_specs(cfg, batch)}
    return {"rglru": blocks.rglru_cache_specs(cfg, batch)}


class Layer(nn.Module):
    """One residual block: pre-norm mixer, then (in an encoder-decoder)
    pre-norm cross-attention, then (but for ``ssd``) a pre-norm MLP or
    MoE.  ``blks`` overrides the blocks (the encoder's attn + mlp)."""

    def __init__(self, cfg, kind: str, device, blks=None):
        super().__init__()
        self.blks = blks or _layer_blocks(cfg, kind)
        self.mixer = self.blks[0]
        self.window = cfg.window if kind == "local" else None
        for blk in self.blks:
            self.add_module(blk, _BLOCKS[blk][0](cfg, device))

    def forward(self, ctx: Ctx, x, positions, *, cache=None,
                return_cache=False, causal=True, enc_kv=None):
        """Returns (x, new_cache).  ``enc_kv``: this layer's
        cross-attention K/V (prefill); decode reads it from ``cache``."""
        mixer = getattr(self, self.mixer)
        h = rms_norm(x, mixer.ln)
        kw = dict(cache=cache[self.mixer] if cache else None,
                  return_cache=return_cache)
        if self.mixer == "attn":
            out, nc = mixer(ctx, h, positions, causal=causal,
                            window=self.window, **kw)
        else:
            out, nc = mixer(h, **kw)
        x = x + out
        new = {} if nc is None else {self.mixer: nc}
        if "xattn" in self.blks:
            if cache:
                enc_kv = cache["xattn"]
            out, _ = self.xattn(ctx, rms_norm(x, self.xattn.ln), positions,
                                kv_override=enc_kv)
            x = x + out
            if cache or return_cache:
                new["xattn"] = enc_kv
        if "moe" in self.blks:
            out, _ = self.moe(ctx, rms_norm(x, self.moe.ln))   # aux dropped
            x = x + out
        elif "mlp" in self.blks:
            x = x + self.mlp(rms_norm(x, self.mlp.ln))
        return x, new


class Encoder(SpecModule):
    """The whisper encoder over the audio stub's frame embeddings: input
    projection, learned positions, non-causal attention + MLP layers, a
    final norm (the JAX ``LM.encode``)."""

    def __init__(self, cfg, device):
        super().__init__(self.top_specs(cfg), device)
        self.layers = nn.ModuleList(
            Layer(cfg, "attn", device, blks=("attn", "mlp"))
            for _ in range(cfg.encoder_layers))

    @staticmethod
    def top_specs(cfg) -> dict[str, TSpec]:
        fd = cfg.frontend_dim or cfg.d_model
        return {"in_proj": TSpec((fd, cfg.d_model), cfg.param_dtype),
                "pos_embed": TSpec((cfg.frontend_tokens, cfg.d_model),
                                   cfg.param_dtype),
                "final_ln": TSpec((cfg.d_model,), "float32", init="zeros")}

    def forward(self, ctx: Ctx, frames: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        """frames: (B, S, frontend_dim) -> (B, S, D)."""
        x = frames.to(dtype) @ self.in_proj.to(dtype)
        x = x + self.pos_embed[None, :x.shape[1]].to(dtype)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        for layer in self.layers:
            x, _ = layer(ctx, x, positions, causal=False)
        return rms_norm(x, self.final_ln)


class LM(SpecModule):
    """The LM of every family.  Parameters carry the JAX tree's names
    (``embed``, ``final_ln``, ``pos_embed``, ``frontend_proj``,
    ``layers.<i>.<block>.<name>``, ``encoder.<name>``).

    ``device`` defaults to ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` for the plain-torch path.  With a ``generator`` the
    weights are drawn from it (:func:`~.common.init_from_specs`);
    without one they stay uninitialized for ``load_state_dict``.
    ``moe_impl``, ``mesh`` and ``moe_capacity_factor`` choose the MoE
    path (:class:`~.blocks.Ctx`).
    """

    def __init__(self, cfg, *, device="cuda",
                 generator: torch.Generator | None = None,
                 moe_impl: str = "ragged", mesh=None,
                 moe_capacity_factor: float = 1.25):
        check_supported(cfg)
        dev = resolve_device(device)
        super().__init__(self.top_specs(cfg), dev)
        self.cfg = cfg
        self.device = dev
        self.dtype = torch_dtype(cfg.dtype)
        self.ctx = Ctx(cfg=cfg, moe_impl=moe_impl, mesh=mesh,
                       moe_capacity_factor=moe_capacity_factor)
        self.layers = nn.ModuleList(Layer(cfg, k, dev) for k in cfg.pattern)
        self.encoder = Encoder(cfg, dev) if cfg.encoder_layers else None
        if generator is not None:
            init_from_specs(self, generator)

    @staticmethod
    def top_specs(cfg) -> dict[str, TSpec]:
        pd = cfg.param_dtype
        p = {"embed": TSpec((cfg.vocab_size, cfg.d_model), pd),
             "final_ln": TSpec((cfg.d_model,), "float32", init="zeros")}
        if not cfg.tied_embeddings:
            p["lm_head"] = TSpec((cfg.d_model, cfg.vocab_size), pd)
        if cfg.rope_theta == 0:
            p["pos_embed"] = TSpec((MAX_LEARNED_POS, cfg.d_model), pd)
        if cfg.frontend == "vision_stub":
            p["frontend_proj"] = TSpec((cfg.frontend_dim or cfg.d_model,
                                        cfg.d_model), pd)
        return p

    @classmethod
    def param_specs(cls, cfg) -> dict[str, TSpec]:
        """Every parameter by its ``state_dict`` name, without allocating."""
        check_supported(cfg)
        out = dict(cls.top_specs(cfg))

        def add(prefix, per_layer):
            for blk, specs in per_layer.items():
                for name, s in specs.items():
                    out[f"{prefix}.{blk}.{name}"] = s
        for i, kind in enumerate(cfg.pattern):
            add(f"layers.{i}", _layer_specs(cfg, kind))
        if cfg.encoder_layers:
            for name, s in Encoder.top_specs(cfg).items():
                out[f"encoder.{name}"] = s
            enc_layer = {"attn": blocks.attn_specs(cfg),
                         "mlp": blocks.mlp_specs(cfg)}
            for i in range(cfg.encoder_layers):
                add(f"encoder.layers.{i}", enc_layer)
        return out

    def cache_specs(self, batch: int, cache_len: int) -> list[dict]:
        """The decode cache :meth:`prefill` returns, layer by layer."""
        return [_layer_cache_specs(self.cfg, k, batch, cache_len)
                for k in self.cfg.pattern]

    # -- embedding / head --------------------------------------------------
    def _embed(self, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens.long()].to(self.dtype)
        # sqrt(d) rounded to the model dtype before the multiply
        x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=self.dtype,
                             device=x.device)
        if self.cfg.rope_theta == 0:
            x = x + self.pos_embed[positions.long()].to(self.dtype)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_ln)
        if self.cfg.tied_embeddings:
            return x @ self.embed.to(self.dtype).T
        return x @ self.lm_head.to(self.dtype)

    # -- entry points --------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, cache_len: int,
                frontend_embeds: torch.Tensor | None = None):
        """tokens: (B, T) int; ``frontend_embeds``: the stub's (B, S, F)
        frame embeddings (whisper: the encoder's input) or (B, P, F)
        patch embeddings (the VLM: P image tokens placed before the text,
        so ``cache_len`` must hold P + T).  Returns ((B, 1, V) logits of
        the last position, the per-layer cache list)."""
        cfg = self.cfg
        b, t = tokens.shape
        if (cfg.encoder_layers or cfg.frontend != "none") and \
                frontend_embeds is None:
            raise ValueError(f"{cfg.name} needs frontend_embeds "
                             f"({cfg.frontend})")
        positions = torch.arange(t, dtype=torch.int32,
                                 device=self.device).expand(b, t)
        ctx = dataclasses.replace(self.ctx, cache_len=cache_len)
        x = self._embed(tokens, positions)
        enc_out = None
        if cfg.encoder_layers:
            enc_out = self.encoder(ctx, frontend_embeds, self.dtype)
        elif cfg.frontend == "vision_stub":
            img = frontend_embeds.to(self.dtype) @ \
                self.frontend_proj.to(self.dtype)
            x = torch.cat([img, x], dim=1)
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=self.device).expand(b, -1)
        caches = []
        for layer in self.layers:
            enc_kv = (layer.xattn.encoder_kv(enc_out)
                      if enc_out is not None and "xattn" in layer.blks
                      else None)
            x, c = layer(ctx, x, positions, return_cache=True, enc_kv=enc_kv)
            caches.append(c)
        return self._head(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: list,
                    positions: torch.Tensor):
        """One token.  tokens, positions: (B, 1).  Returns ((B, 1, V)
        logits, cache); the attention ring buffers are updated in place."""
        x = self._embed(tokens, positions)
        new = []
        for layer, c in zip(self.layers, cache):
            x, nc = layer(self.ctx, x, positions, cache=c)
            new.append(nc)
        return self._head(x), new
