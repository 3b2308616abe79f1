"""Int8 gradient compression with error feedback.

The port's copy of ``repro/dist/compression.py``: per-row int8 codes
(absmax of the last axis / 127, round half to even, as ``jnp.round``)
for the gradients that would cross a pod boundary, and an optimizer
wrapper that feeds each step's rounding error back into the next
(Seide et al. 2014).  Gradients are the optimizers' leaves
(``convert.jax_leaves``): a leaf that is a stack's per-layer list is
coded as the JAX package codes the stacked leaf (the rows are the last
axis, so per layer) and comes back whole.
"""
from __future__ import annotations

import torch

from ..train.optimizer import Optimizer, whole

_EPS = 1e-12


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``g`` (float32/bf16) -> (int8 codes, float32 per-row scale):
    ``absmax / 127`` over the last axis (keepdims), so
    ``dequantize_int8(*quantize_int8(g))`` is within half a quantum of
    ``g``."""
    gf = g.float()
    scalar = gf.ndim == 0
    if scalar:
        gf = gf[None]
        absmax = gf.abs()
    else:
        absmax = gf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=_EPS) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    if scalar:
        return q[0], scale[0]
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: dict, residual: dict) -> tuple[dict, dict]:
    """One encode/decode round over the gradient leaves: (decoded, in the
    gradients' types, and the float32 rounding error to feed back, taken
    against what the caller receives)."""
    decoded, new_res = {}, {}
    for k, g in grads.items():
        gw = whole(g)
        total = gw.float() + residual[k]
        dec = dequantize_int8(*quantize_int8(total)).to(gw.dtype)
        decoded[k] = dec
        new_res[k] = total - dec.float()
    return decoded, new_res


def make_pod_compress_fn(mesh=None, *, n_pods: int | None = None,
                         pod_axis: str = "pod"):
    """The gradient codec for the pod-boundary reduction, and only that:
    ``None`` when no pod boundary exists (no mesh, no ``pod`` axis, or
    one pod), else a ``compress_fn`` for ``make_train_step`` (one int8
    encode/decode round per leaf, stateless; error feedback lives in
    :func:`compressed`)."""
    if n_pods is None:
        if mesh is None:
            return None
        names = tuple(getattr(mesh, "axis_names", ()))
        if pod_axis not in names:
            return None
        devices = getattr(mesh, "devices", None)
        sizes = dict(zip(names, devices.shape)) if devices is not None \
            else {}
        n_pods = int(sizes.get(pod_axis, 1))
    if n_pods <= 1:
        return None

    def compress_fn(grads: dict) -> dict:
        return {k: dequantize_int8(*quantize_int8(whole(g))).to(
            whole(g).dtype) for k, g in grads.items()}

    return compress_fn


def compressed(opt: Optimizer) -> Optimizer:
    """``opt`` with its incoming gradients passed through int8 codes with
    error feedback.  State: ``{"inner": opt's state, "ef": float32
    residual per leaf, stacked as the leaf}``."""
    def init(params: dict) -> dict:
        return {"inner": opt.init(params),
                "ef": {k: torch.zeros(whole(p).shape, dtype=torch.float32,
                                      device=whole(p).device)
                       for k, p in params.items()}}

    def update(grads, state, params, step):
        decoded, new_ef = compress_tree(grads, state["ef"])
        params, inner = opt.update(decoded, state["inner"], params, step)
        return params, {"inner": inner, "ef": new_ef}

    return Optimizer(init, update)
