"""Sharding planner: logical tensor axes -> mesh axes, per config.

The port's copy of ``repro/dist/sharding.py``.  The model code names
every tensor's *logical* axes (``TSpec.axes``: "vocab", "embed", "ff",
"heads", "experts", "rnn", "batch", "seq", "hd", "layers", ...).
:func:`make_plan` reads the mesh and an ``ArchConfig`` and produces a
:class:`Plan`; :func:`spec_for` then maps a ``TSpec`` to a
:class:`PartitionSpec` under three rules:

1. **TP rule** -- "vocab"/"ff"/"heads"/"experts"/"rnn" shard over the
   ``model`` axis when ``cfg.tp``; "embed" shards over ``data`` when
   ``cfg.fsdp`` (ZeRO-3 style); "seq" may take ``model`` when
   ``cfg.seq_shard`` (flash-decode style sequence sharding).
2. **Divisibility fallback** -- a dim whose size does not divide its
   mesh axis replicates instead, and the decision is recorded in
   ``plan.fallbacks``.
3. **One-mesh-axis-per-tensor rule** -- within one tensor each mesh axis
   is claimed at most once, first (leftmost) logical dim wins, so the
   order of the dims is the priority ladder (a KV cache's "heads" >
   "seq" > "hd").

Batch dims use the DP ladder (:func:`batch_axes_for`): the widest rung of
``("pod", "data", "model")`` whose total size divides the batch, giving
up "model" first (it is the TP axis when ``cfg.tp``) and "pod" second,
so plain "data" sharding survives the smallest batches.

The port has no ``NamedSharding``: a spec is a :class:`PartitionSpec`
(a tuple whose entries are ``None``, an axis name or a tuple of names)
and a sharding is a :class:`Sharding`, ``(mesh, spec)``.  A mesh is
anything with ``.axis_names`` and ``.devices`` (an array in the mesh's
shape): ``dist.mesh.Mesh`` or a test's fake.  The port's parameters are
per layer (no "layers" axis) with batch on axis 0 of caches, so each of
their specs equals the JAX leaf's with the leading "layers" entry
stripped; the optimizer state is kept per JAX leaf, stacked, as the
port's optimizers keep it.

The sharded compaction path calls ``make_plan(mesh)``: the plan of a
config with tensor parallel on, so the ``model`` axis is reserved and
rows shard over the data-parallel axes.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, NamedTuple

import torch

from ..convert import jax_leaves
from ..models.common import TSpec, torch_dtype

# logical axes that ride the TP ("model") mesh axis, in no particular
# order -- per-tensor priority is the order of the dims in the TSpec
_TP_AXES = ("vocab", "ff", "heads", "experts", "rnn")

# the compaction path's layout policy: model axis reserved, nothing else
_COMPACTION = types.SimpleNamespace(tp=True, fsdp=False, seq_shard=False)


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name
    or a tuple of names (the JAX ``PartitionSpec``'s entries)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Sharding(NamedTuple):
    """A tensor's placement: its spec over a mesh."""
    mesh: Any
    spec: PartitionSpec

    @property
    def device(self) -> torch.device:
        """Where the tensor lives.  The port keeps a tensor whole on one
        device: its mesh's first entry, which is every entry's device on
        one card.  A spec that would split a dim over entries on distinct
        devices raises."""
        devices = {torch.device(d) for d in self.mesh.devices.flat}
        if len(devices) > 1 and any(e is not None for e in self.spec):
            raise NotImplementedError(
                f"spec {self.spec} splits a tensor over "
                f"{sorted(map(str, devices))}; the port keeps each tensor "
                "whole on one device")
        return torch.device(self.mesh.devices.flat[0])


@dataclasses.dataclass
class Plan:
    """Resolved layout policy for one (config, mesh) pair."""
    cfg: Any
    mesh: Any
    axis_sizes: dict[str, int]
    tp: bool                      # model axis reserved for tensor parallel
    fsdp: bool                    # params/opt-state sharded over data
    seq_shard: bool               # activations may shard seq over model
    dp_axes: tuple[str, ...]      # mesh axes available for batch sharding
    ladder: tuple[tuple[str, ...], ...]   # DP rungs, widest first
    fallbacks: list[str] = dataclasses.field(default_factory=list)

    @property
    def model_axis(self) -> str | None:
        return "model" if self.tp and "model" in self.axis_sizes else None

    def size(self, axis: str) -> int:
        return self.axis_sizes.get(axis, 1)

    def note_fallback(self, msg: str) -> None:
        if msg not in self.fallbacks:
            self.fallbacks.append(msg)


def make_plan(cfg, mesh=None) -> Plan:
    """The plan of ``cfg`` (its ``tp``, ``fsdp``, ``seq_shard``) on
    ``mesh``; ``make_plan(mesh)`` is the compaction path's plan (tensor
    parallel on: the ``model`` axis is reserved).  The rule logic is
    device-free: only ``mesh.axis_names`` and ``mesh.devices.shape`` are
    read."""
    if mesh is None:
        cfg, mesh = _COMPACTION, cfg
    names = tuple(mesh.axis_names)
    sizes = dict(zip(names, mesh.devices.shape))
    tp = bool(cfg.tp) and "model" in sizes
    dp = tuple(n for n in names if not (tp and n == "model"))

    # DP ladder: sacrifice "model" first, then "pod"; "data" dies last
    rungs = [dp]
    remaining = list(dp)
    for drop in ("model", "pod"):
        if drop in remaining:
            remaining = [a for a in remaining if a != drop]
            rungs.append(tuple(remaining))
    if rungs[-1]:
        rungs.append(())
    return Plan(cfg=cfg, mesh=mesh, axis_sizes=sizes, tp=tp,
                fsdp=bool(cfg.fsdp), seq_shard=bool(cfg.seq_shard),
                dp_axes=dp, ladder=tuple(rungs))


# ---------------------------------------------------------------------------
# batch ladder
# ---------------------------------------------------------------------------

def batch_axes_for(plan: Plan, batch: int) -> tuple[str, ...]:
    """Widest DP rung whose device count divides ``batch``."""
    for rung in plan.ladder:
        n = 1
        for a in rung:
            n *= plan.size(a)
        if n and batch % n == 0:
            return rung
    return ()


def _batch_entry(plan: Plan, batch: int):
    """PartitionSpec entry for a batch dim: str | tuple | None."""
    axes = batch_axes_for(plan, batch)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


# ---------------------------------------------------------------------------
# tensor specs
# ---------------------------------------------------------------------------

def _candidates(plan: Plan, logical: str | None) -> tuple[str, ...]:
    if logical in _TP_AXES and plan.model_axis:
        return (plan.model_axis,)
    if logical == "embed" and plan.fsdp and "data" in plan.axis_sizes:
        return ("data",)
    if logical == "seq" and plan.seq_shard and plan.model_axis:
        return (plan.model_axis,)
    if logical == "hd" and plan.model_axis:   # last resort
        return (plan.model_axis,)
    return ()


def spec_for(plan: Plan, tspec: TSpec) -> PartitionSpec:
    """Map one ``TSpec`` to a :class:`PartitionSpec` under the plan's
    rules."""
    axes = tspec.axes or (None,) * len(tspec.shape)
    used: set[str] = set()
    entries: list = []
    for dim, logical in zip(tspec.shape, axes):
        if logical == "batch":
            entry = _batch_entry(plan, dim)
            picked = entry if isinstance(entry, tuple) else (
                (entry,) if entry else ())
            if any(a in used for a in picked):
                entry = None
            else:
                used.update(picked)
            entries.append(entry)
            continue
        entry = None
        for cand in _candidates(plan, logical):
            if cand in used:
                continue               # one-mesh-axis-per-tensor rule
            if dim % plan.size(cand) == 0:
                entry = cand
                used.add(cand)
                break
            if logical != "hd":        # hd replicas are free, stay quiet
                plan.note_fallback(
                    f"{logical}: {dim} % {cand}={plan.size(cand)} != 0 "
                    f"-> replicated")
        entries.append(entry)
    return P(*entries)


def _map_specs(fn, tree):
    """``fn`` over every ``TSpec`` leaf of nested dicts, lists and tuples."""
    if isinstance(tree, TSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    raise TypeError(f"not a TSpec tree leaf: {type(tree).__name__}")


def tree_shardings(plan: Plan, spec_tree):
    """TSpec tree -> :class:`Sharding` tree over ``plan.mesh``."""
    return _map_specs(lambda s: Sharding(plan.mesh, spec_for(plan, s)),
                      spec_tree)


# ---------------------------------------------------------------------------
# activations / attention
# ---------------------------------------------------------------------------

def act_spec(plan: Plan, batch: int, *, seq: int | None = None,
             decode: bool = False) -> PartitionSpec:
    """(B, T, D) residual-stream spec.  Sequence takes the model axis for
    seq-sharded TP archs on divisible lengths; decode (T=1) and uneven
    lengths replicate T."""
    b = _batch_entry(plan, batch)
    t = None
    if not decode and seq and plan.seq_shard and plan.model_axis:
        if seq % plan.size(plan.model_axis) == 0:
            t = plan.model_axis
        else:
            plan.note_fallback(
                f"seq: {seq} % {plan.model_axis}="
                f"{plan.size(plan.model_axis)} != 0 -> replicated")
    return P(b, t, None)


def qkv_specs(plan: Plan, cfg, batch: int, *, seq: int | None = None
              ) -> tuple[PartitionSpec, PartitionSpec, PartitionSpec]:
    """Specs for head-major attention tensors.

    Returns ``(q, kv, grouped)`` for layouts ``(B, H, T, hd)``,
    ``(B, Hkv, T, hd)`` and ``(B, Hkv, G, T, hd)`` (G = Hq/Hkv).

    The KV head count owns the layout decision: when it divides the
    model axis, q/kv/grouped all pin heads to ``model``.  When it does
    not, q/kv stay replicated over heads and the grouped tensor sheds TP
    onto its group dim, then its seq dim, then gives up.
    """
    b = _batch_entry(plan, batch)
    m = plan.model_axis
    kv_heads = cfg.n_kv_heads
    heads = cfg.n_heads
    if m and kv_heads and kv_heads % plan.size(m) == 0 \
            and heads % plan.size(m) == 0:
        return (P(b, m, None, None), P(b, m, None, None),
                P(b, m, None, None, None))
    if m and kv_heads:
        bad = (f"kv={kv_heads}" if kv_heads % plan.size(m)
               else f"q={heads}")
        plan.note_fallback(
            f"heads: {bad} % {m}={plan.size(m)} != 0 "
            f"-> q/kv heads replicated")
    q = P(b, None, None, None)
    kv = P(b, None, None, None)
    group = heads // kv_heads if kv_heads else 0
    if m and group and group % plan.size(m) == 0:
        grp = P(b, None, m, None, None)
    elif m and seq and seq % plan.size(m) == 0:
        grp = P(b, None, None, m, None)      # q-seq fallback
    else:
        grp = P(b, None, None, None, None)
    return q, kv, grp


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------

def _stack(leaf) -> TSpec:
    """A JAX leaf's TSpec: a per-layer list stacked under "layers"."""
    if not isinstance(leaf, list):
        return leaf
    s = leaf[0]
    return TSpec((len(leaf),) + s.shape, s.dtype,
                 ("layers",) + (s.axes or (None,) * len(s.shape)), s.init)


def param_leaf_specs(cfg, param_specs: dict) -> dict:
    """The port's ``{name: TSpec}`` (``LM.param_specs``) as the JAX
    leaves the optimizer keeps: ``{path: TSpec}``, a layer-stacked leaf
    with its leading "layers" axis."""
    return {k: _stack(v) for k, v in jax_leaves(cfg, param_specs).items()}


def opt_state_specs(cfg, param_specs: dict) -> dict:
    """TSpec tree of the optimizer state, structurally identical to
    ``make_optimizer(cfg).init(param_leaves(model))`` (same keys, leaf
    order and shapes).  Moments inherit the parameter's logical axes
    verbatim; adafactor's factored row/col statistics drop the reduced
    dim's axis."""
    leaves = param_leaf_specs(cfg, param_specs)
    if cfg.optimizer == "adafactor":
        def factored(p: TSpec):
            axes = p.axes or (None,) * len(p.shape)
            if len(p.shape) >= 2:
                return {"vr": TSpec(p.shape[:-1], "float32", axes[:-1],
                                    init="zeros"),
                        "vc": TSpec(p.shape[:-2] + p.shape[-1:], "float32",
                                    axes[:-2] + axes[-1:], init="zeros")}
            return {"v": TSpec(p.shape, "float32", axes, init="zeros")}
        return {"f": {k: factored(p) for k, p in leaves.items()}}

    def moment(p: TSpec):
        return TSpec(p.shape, cfg.opt_state_dtype,
                     p.axes or (None,) * len(p.shape), init="zeros")
    return {key: {k: moment(p) for k, p in leaves.items()}
            for key in ("m", "v")}


# ---------------------------------------------------------------------------
# launcher helpers (dry-run wiring)
# ---------------------------------------------------------------------------

def _strip_layer_dim(s: TSpec) -> TSpec:
    if s.axes and s.axes[0] == "layers":
        return TSpec(s.shape[1:], s.dtype, s.axes[1:], s.init)
    return s


def layer_compute_specs(plan: Plan, layer_specs):
    """Per-layer spec tree of a layer's parameters (a list of them for a
    list of layers).  The port's layer specs carry no "layers" axis; a
    stacked one is stripped first, as the JAX scan body does."""
    return _map_specs(lambda s: spec_for(plan, _strip_layer_dim(s)),
                      layer_specs)


def batch_sharding(plan: Plan, batch: int) -> Sharding:
    """Sharding for a batch-leading tensor: a rank-1 prefix spec, so the
    same sharding serves (B,) tokens, (B, T) prompts and (B, 1) decode
    steps (trailing dims replicate)."""
    return Sharding(plan.mesh, P(_batch_entry(plan, batch)))


def batch_tree_shardings(plan: Plan, batch_tree: dict) -> dict:
    """Shardings for a batch dict of tensors: leading dim over the DP
    ladder, the rest replicated."""
    def of(leaf):
        b = _batch_entry(plan, leaf.shape[0]) if leaf.ndim else None
        return Sharding(plan.mesh, P(b, *(None,) * max(leaf.ndim - 1, 0)))
    return {k: of(v) for k, v in batch_tree.items()}


def _meta(s: TSpec) -> torch.Tensor:
    return torch.empty(s.shape, dtype=torch_dtype(s.dtype), device="meta")


def train_state_shapes(cfg, model=None):
    """The ``TrainState`` of ``init_train_state`` as meta tensors (the
    port's stand-in for ``ShapeDtypeStruct``): params as JAX leaves (a
    stack's per-layer list), the optimizer state, step 0.  ``model`` is
    accepted for the JAX signature; the shapes follow ``cfg``."""
    from ..models.lm import LM
    from ..train.train_step import TrainState

    specs = LM.param_specs(cfg)
    params = {k: [_meta(s) for s in v] if isinstance(v, list) else _meta(v)
              for k, v in jax_leaves(cfg, specs).items()}
    opt = _map_specs(_meta, opt_state_specs(cfg, specs))
    return TrainState(params, opt, 0)


def train_state_shardings(plan: Plan, cfg, param_specs: dict):
    """The :class:`Sharding` ``TrainState`` matching
    :func:`train_state_shapes`: a stack's per-layer parameters each with
    its own spec, the optimizer state per JAX leaf, the step replicated."""
    from ..train.train_step import TrainState

    return TrainState(
        tree_shardings(plan, jax_leaves(cfg, param_specs)),
        tree_shardings(plan, opt_state_specs(cfg, param_specs)),
        Sharding(plan.mesh, P()))


__all__ = ["P", "PartitionSpec", "Plan", "Sharding", "act_spec",
           "batch_axes_for", "batch_sharding", "batch_tree_shardings",
           "layer_compute_specs", "make_plan", "opt_state_specs",
           "param_leaf_specs", "qkv_specs", "spec_for", "tree_shardings",
           "train_state_shapes", "train_state_shardings"]
