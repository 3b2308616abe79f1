"""Optimizers: AdamW and Adafactor over the JAX package's parameter leaves.

The port's copy of ``repro/train/optimizer.py``.  Both decide per JAX
leaf: AdamW decays a leaf that is a matrix (``ndim >= 2``) and not a
norm; Adafactor factors the second moment of a leaf with ``ndim >= 2``
and clips its update by the update's RMS over the whole leaf.  The JAX
package stacks a homogeneous stack's layers into one leaf (``layers.attn
.bq`` of shape ``(L, n)``), the port keeps one tensor per layer.  So the
optimizers take the parameters as *leaves*
(:func:`repro_torch.convert.jax_leaves`): a dict from the JAX leaf's
dotted path to a tensor, or to the list of its per-layer tensors, which
the update stacks into the JAX leaf, updates, and writes back.  A
stacked bias is then decayed, factored and clipped as in JAX.

State mirrors JAX leaf for leaf, stacked where the leaf is: AdamW
``{"m": {path: t}, "v": {path: t}}`` in ``opt_state_dtype``; Adafactor
``{"f": {path: {"vr", "vc"} or {"v"}}}`` in float32.

``update(grads, state, params, step) -> (params, state)`` writes the new
values into the parameter tensors (the model's own) and returns them
with the new state.  The arithmetic is the JAX package's, in float32.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..models.common import torch_dtype

Leaf = torch.Tensor | list          # a tensor, or a stack's per-layer list


class Optimizer(NamedTuple):
    """A pair of functions (the optax contract of the JAX package)."""
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], tuple[Any, Any]]


def whole(leaf: Leaf) -> torch.Tensor:
    """The JAX leaf: a stack's per-layer tensors stacked on axis 0."""
    return torch.stack(leaf) if isinstance(leaf, list) else leaf


def _write(leaf: Leaf, new: torch.Tensor) -> None:
    if isinstance(leaf, list):
        for t, n in zip(leaf, new):
            t.copy_(n)
    else:
        leaf.copy_(new)


def _shape(leaf: Leaf) -> tuple[int, ...]:
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def _device(leaf: Leaf) -> torch.device:
    return (leaf[0] if isinstance(leaf, list) else leaf).device


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[int], torch.Tensor]:
    """Linear warmup then cosine decay to ``floor * base_lr``: step ->
    float32 learning rate (0-d, on the CPU), as the JAX schedule
    computes it."""
    def lr(step: int) -> torch.Tensor:
        s = _f32(step, "cpu")
        warm = base_lr * (s + 1) / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, base_lr * cos)
    return lr


def global_norm(leaves: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32."""
    total = 0
    for leaf in leaves.values():
        for t in (leaf if isinstance(leaf, list) else [leaf]):
            total = total + torch.sum(torch.square(t.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(leaves: dict, max_norm: float):
    """(leaves scaled by ``min(1, max_norm / (norm + 1e-9))`` in their own
    types, the norm)."""
    norm = global_norm(leaves)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)

    def one(t):
        return (t.float() * scale).to(t.dtype)
    return {k: [one(t) for t in leaf] if isinstance(leaf, list)
            else one(leaf) for k, leaf in leaves.items()}, norm


def _decay_mask(path: str) -> bool:
    """Weight decay only on matrices (not on norms): the leaf's name."""
    name = path.rsplit(".", 1)[-1]
    return "ln" not in name and "norm" not in name


def adamw(lr: Callable | float, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float = 1.0, state_dtype: str = "float32") -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: _f32(lr, "cpu"))
    sdt = torch_dtype(state_dtype)

    def init(params: dict) -> dict:
        return {key: {k: torch.zeros(_shape(p), dtype=sdt,
                                     device=_device(p))
                      for k, p in params.items()} for key in ("m", "v")}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict, step: int):
        grads, _ = clip_by_global_norm(grads, clip_norm)
        stepf = _f32(step + 1, "cpu")
        dev = _device(next(iter(params.values())))
        c1, c2, lr_t = (x.to(dev) for x in (1.0 - b1 ** stepf,
                                            1.0 - b2 ** stepf, lr_fn(step)))
        new_m, new_v = {}, {}
        for k, p in params.items():
            gf = whole(grads[k]).float()
            pw = whole(p)
            m = b1 * state["m"][k].float() + (1 - b1) * gf
            v = b2 * state["v"][k].float() + (1 - b2) * gf * gf
            step_dir = (m / c1) / (torch.sqrt(v / c2) + eps)
            if _decay_mask(k) and pw.ndim >= 2:
                step_dir = step_dir + weight_decay * pw.float()
            _write(p, (pw.float() - lr_t * step_dir).to(pw.dtype))
            new_m[k], new_v[k] = m.to(sdt), v.to(sdt)
        return params, {"m": new_m, "v": new_v}

    return Optimizer(init, update)


def adafactor(lr: Callable | float, *, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018) with a factored second moment
    for every leaf of ``ndim >= 2``."""
    lr_fn = lr if callable(lr) else (lambda _: _f32(lr, "cpu"))

    def init(params: dict) -> dict:
        def state_of(p):
            shape, dev = _shape(p), _device(p)
            if len(shape) >= 2:
                return {"vr": torch.zeros(shape[:-1], dtype=torch.float32,
                                          device=dev),
                        "vc": torch.zeros(shape[:-2] + shape[-1:],
                                          dtype=torch.float32, device=dev)}
            return {"v": torch.zeros(shape, dtype=torch.float32, device=dev)}
        return {"f": {k: state_of(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict, step: int):
        stepf = _f32(step + 1, "cpu")
        dev = _device(next(iter(params.values())))
        bt, lr_t = (x.to(dev) for x in (1.0 - stepf ** (-decay),
                                        lr_fn(step)))
        new_f = {}
        for k, p in params.items():
            s = state["f"][k]
            gf = whole(grads[k]).float()
            pw = whole(p)
            pf = pw.float()
            g2 = gf * gf + eps
            if pf.ndim >= 2:
                vr = bt * s["vr"] + (1 - bt) * torch.mean(g2, dim=-1)
                vc = bt * s["vc"] + (1 - bt) * torch.mean(g2, dim=-2)
                denom = torch.mean(vr, dim=-1, keepdim=True)
                r = (vr / torch.clamp(denom, min=eps))[..., None]
                u = gf * torch.rsqrt(torch.clamp(r, min=eps)) \
                    * torch.rsqrt(torch.clamp(vc[..., None, :], min=eps))
                new_f[k] = {"vr": vr, "vc": vc}
            else:
                v = bt * s["v"] + (1 - bt) * g2
                u = gf * torch.rsqrt(torch.clamp(v, min=eps))
                new_f[k] = {"v": v}
            rms_u = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            if weight_decay and pf.ndim >= 2:
                u = u + weight_decay * pf
            _write(p, (pf - lr_t * u).to(pw.dtype))
        return params, {"f": new_f}

    return Optimizer(init, update)


def make_optimizer(cfg, *, base_lr: float = 3e-4, warmup: int = 100,
                   total: int = 10_000) -> Optimizer:
    """Config-driven choice (``cfg.optimizer``, ``cfg.opt_state_dtype``)."""
    sched = cosine_schedule(base_lr, warmup, total)
    if cfg.optimizer == "adafactor":
        return adafactor(sched)
    return adamw(sched, state_dtype=cfg.opt_state_dtype)
