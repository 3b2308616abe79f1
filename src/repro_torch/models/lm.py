"""LM assembly for the hybrid, dense and SSM stacks: embed, per-layer
blocks, head.

The port's copy of ``repro/models/lm.py`` for the decoder-only families
it runs: one :class:`Layer` per entry of ``cfg.pattern`` (``local``/
``attn`` -> attention + MLP, ``rglru`` -> RG-LRU + MLP, ``ssd`` -> the
mamba2 mixer alone), two entry points -- :meth:`LM.prefill` (builds the
decode cache) and :meth:`LM.decode_step` (one token) -- and caches as a
per-layer list of dicts whose tensors all have batch on axis 0.  The
JAX package scans a homogeneous stack (dense, SSM) over a layer-stacked
param tree and unrolls a heterogeneous one; here both are an
``nn.ModuleList`` of layers, named ``layers.<i>.<block>.<name>``
(``convert.lm_params_from_jax`` unstacks the JAX tree).  MoE, the
whisper encoder, the vision stub and learned positions wait for later
slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.ops import resolve_device
from . import blocks
from .blocks import Ctx
from .common import SpecModule, TSpec, init_from_specs, rms_norm, torch_dtype

# each layer kind's blocks, mixer first, and their modules
_LAYER_BLOCKS = {"attn": ("attn", "mlp"), "local": ("attn", "mlp"),
                 "rglru": ("rglru", "mlp"), "ssd": ("ssd",)}
_BLOCKS = {"attn": (blocks.Attention, blocks.attn_specs),
           "mlp": (blocks.MLP, blocks.mlp_specs),
           "rglru": (blocks.RGLRU, blocks.rglru_specs),
           "ssd": (blocks.SSD, blocks.ssd_specs)}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port cannot run yet."""
    missing = []
    if any(k not in _LAYER_BLOCKS for k in cfg.pattern):
        missing.append(f"layer kinds "
                       f"{sorted(set(cfg.pattern) - set(_LAYER_BLOCKS))}")
    if cfg.n_experts:
        missing.append("MoE")
    if cfg.encoder_layers or cfg.frontend != "none":
        missing.append("encoder / frontend stubs")
    if cfg.rope_theta <= 0:
        missing.append("learned positions")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP.md, "
            "the port's queue)")


def _layer_specs(cfg, kind: str) -> dict[str, dict[str, TSpec]]:
    return {blk: _BLOCKS[blk][1](cfg) for blk in _LAYER_BLOCKS[kind]}


def _layer_cache_specs(cfg, kind: str, batch: int,
                       cache_len: int) -> dict[str, dict[str, TSpec]]:
    if kind in ("attn", "local"):
        return {"attn": blocks.attn_cache_specs(
            cfg, batch, cache_len, cfg.dtype,
            window=cfg.window if kind == "local" else None)}
    if kind == "ssd":
        return {"ssd": blocks.ssd_cache_specs(cfg, batch)}
    return {"rglru": blocks.rglru_cache_specs(cfg, batch)}


class Layer(nn.Module):
    """One residual block: pre-norm mixer, then (but for ``ssd``)
    pre-norm MLP."""

    def __init__(self, cfg, kind: str, device):
        super().__init__()
        self.mixer, *rest = _LAYER_BLOCKS[kind]
        self.window = cfg.window if kind == "local" else None
        for blk in (self.mixer, *rest):
            self.add_module(blk, _BLOCKS[blk][0](cfg, device))

    def forward(self, ctx: Ctx, x, positions, *, cache=None,
                return_cache=False):
        """Returns (x, new_cache)."""
        mixer = getattr(self, self.mixer)
        h = rms_norm(x, mixer.ln)
        kw = dict(cache=cache[self.mixer] if cache else None,
                  return_cache=return_cache)
        if self.mixer == "attn":
            out, nc = mixer(ctx, h, positions, window=self.window, **kw)
        else:
            out, nc = mixer(h, **kw)
        x = x + out
        if self.mixer != "ssd":
            x = x + self.mlp(rms_norm(x, self.mlp.ln))
        return x, ({} if nc is None else {self.mixer: nc})


class LM(SpecModule):
    """The decoder-only LM.  Parameters carry the JAX tree's names
    (``embed``, ``final_ln``, ``layers.<i>.<block>.<name>``).

    ``device`` defaults to ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` for the plain-torch path.  With a ``generator`` the
    weights are drawn from it (:func:`~.common.init_from_specs`);
    without one they stay uninitialized for ``load_state_dict``.
    """

    def __init__(self, cfg, *, device="cuda",
                 generator: torch.Generator | None = None):
        check_supported(cfg)
        dev = resolve_device(device)
        super().__init__(self.top_specs(cfg), dev)
        self.cfg = cfg
        self.device = dev
        self.dtype = torch_dtype(cfg.dtype)
        self.layers = nn.ModuleList(Layer(cfg, k, dev) for k in cfg.pattern)
        if generator is not None:
            init_from_specs(self, generator)

    @staticmethod
    def top_specs(cfg) -> dict[str, TSpec]:
        p = {"embed": TSpec((cfg.vocab_size, cfg.d_model), cfg.param_dtype),
             "final_ln": TSpec((cfg.d_model,), "float32", init="zeros")}
        if not cfg.tied_embeddings:
            p["lm_head"] = TSpec((cfg.d_model, cfg.vocab_size),
                                 cfg.param_dtype)
        return p

    @classmethod
    def param_specs(cls, cfg) -> dict[str, TSpec]:
        """Every parameter by its ``state_dict`` name, without allocating."""
        check_supported(cfg)
        out = dict(cls.top_specs(cfg))
        for i, kind in enumerate(cfg.pattern):
            for blk, specs in _layer_specs(cfg, kind).items():
                for name, s in specs.items():
                    out[f"layers.{i}.{blk}.{name}"] = s
        return out

    def cache_specs(self, batch: int, cache_len: int) -> list[dict]:
        """The decode cache :meth:`prefill` returns, layer by layer."""
        return [_layer_cache_specs(self.cfg, k, batch, cache_len)
                for k in self.cfg.pattern]

    # -- embedding / head --------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens.long()].to(self.dtype)
        # sqrt(d) rounded to the model dtype before the multiply
        return x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=self.dtype,
                                device=x.device)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_ln)
        if self.cfg.tied_embeddings:
            return x @ self.embed.to(self.dtype).T
        return x @ self.lm_head.to(self.dtype)

    # -- entry points --------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, cache_len: int):
        """tokens: (B, T) int.  Returns ((B, 1, V) logits of the last
        position, the per-layer cache list)."""
        b, t = tokens.shape
        positions = torch.arange(t, dtype=torch.int32,
                                 device=self.device).expand(b, t)
        ctx = Ctx(cfg=self.cfg, cache_len=cache_len)
        x = self._embed(tokens)
        caches = []
        for layer in self.layers:
            x, c = layer(ctx, x, positions, return_cache=True)
            caches.append(c)
        return self._head(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: list,
                    positions: torch.Tensor):
        """One token.  tokens, positions: (B, 1).  Returns ((B, 1, V)
        logits, cache); the attention ring buffers are updated in place."""
        ctx = Ctx(cfg=self.cfg)
        x = self._embed(tokens)
        new = []
        for layer, c in zip(self.layers, cache):
            x, nc = layer(ctx, x, positions, cache=c)
            new.append(nc)
        return self._head(x), new
