"""Train-step builder: loss, gradients (with accumulation), optimizer apply.

The port's copy of ``repro/train/train_step.py`` for one device:

* the loss is the fused causal cross-entropy plus ``aux_coef`` times the
  MoE's load-balance loss (:func:`loss_fn`);
* gradients come from ``torch.autograd.grad`` over the model's own
  parameters, as JAX leaves (:func:`repro_torch.convert.jax_leaves`);
  a parameter the graph did not reach (an expert no token chose) gets a
  zero gradient, as ``jax.grad`` gives it;
* **gradient accumulation** (``grad_accum``) splits the batch's leading
  axis into that many microbatches, in order, and sums their gradients
  in float32, or in ``param_dtype`` when ``cfg.fsdp`` is set (the JAX
  accumulator); the loss is their mean and the other metrics the last
  microbatch's;
* the ``compress_fn`` hook sees the gradients before the optimizer.

``TrainState(params, opt, step)``: ``params`` holds the model's
parameters themselves (the optimizer writes their new values in place),
``opt`` the optimizer's state and ``step`` an int.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..convert import jax_leaves
from ..models.common import causal_cross_entropy, torch_dtype
from .optimizer import Optimizer, global_norm


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: int


def param_leaves(model) -> dict:
    """The model's parameters as JAX leaves (the same tensors)."""
    return jax_leaves(model.cfg, dict(model.named_parameters()))


def init_train_state(model, optimizer: Optimizer) -> TrainState:
    """The state of ``model`` as it is (seeded or loaded) at step 0."""
    params = param_leaves(model)
    return TrainState(params, optimizer.init(params), 0)


def load_train_state(model, state: TrainState) -> TrainState:
    """Load a state whose ``params`` is a ``state_dict``
    (``convert.train_state_from_jax``) into ``model``; returns the state
    over the model's own parameters."""
    model.load_state_dict(state.params)
    return TrainState(param_leaves(model), state.opt, state.step)


def loss_fn(model, batch: dict, *, aux_coef: float = 0.01):
    """(ce + aux_coef * aux, {"ce", "aux"})."""
    logits, aux = model(batch["tokens"],
                        frontend_embeds=batch.get("frontend"))
    ce = causal_cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}


def _flat(leaves: dict) -> list[torch.Tensor]:
    return [t for leaf in leaves.values()
            for t in (leaf if isinstance(leaf, list) else [leaf])]


def _unflat(leaves: dict, flat: list) -> dict:
    it = iter(flat)
    return {k: [next(it) for _ in leaf] if isinstance(leaf, list)
            else next(it) for k, leaf in leaves.items()}


def make_train_step(model, optimizer: Optimizer, *, grad_accum: int = 1,
                    compress_fn: Callable | None = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: {"tokens": (B, T) int, "labels": (B, T) int, optional
    "mask": (B, T), optional "frontend": (B, P, F)} on the model's
    device.  Metrics: ``loss``, ``ce``, ``aux``, ``grad_norm`` (0-d
    tensors) and ``step`` (the step this update was taken at)."""
    cfg = model.cfg
    accum_dtype = torch_dtype(cfg.param_dtype) if cfg.fsdp else \
        torch.float32

    def grads_of(params: dict, batch: dict):
        flat = _flat(params)
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, flat)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def accumulate(params: dict, batch: dict):
        if grad_accum <= 1:
            return grads_of(params, batch)
        micro = {k: v.chunk(grad_accum, dim=0) for k, v in batch.items()}
        loss_sum, acc = 0, None
        for i in range(grad_accum):
            loss, metrics, g = grads_of(params,
                                        {k: v[i] for k, v in micro.items()})
            g = [x.to(accum_dtype) for x in g]
            acc = g if acc is None else [a + x for a, x in zip(acc, g)]
            loss_sum = loss_sum + loss
        return (loss_sum / grad_accum, metrics,
                [a / grad_accum for a in acc])

    def train_step(state: TrainState, batch: dict):
        if next(iter(batch.values())).shape[0] % max(grad_accum, 1):
            raise ValueError(f"batch does not split into {grad_accum} "
                             "microbatches")
        loss, metrics, grads = accumulate(state.params, batch)
        grads = _unflat(state.params, grads)
        if compress_fn is not None:
            grads = compress_fn(grads)
        params, opt = optimizer.update(grads, state.opt, state.params,
                                       state.step)
        metrics = dict(metrics, loss=loss, grad_norm=global_norm(grads),
                       step=state.step)
        return TrainState(params, opt, state.step + 1), metrics

    return train_step

