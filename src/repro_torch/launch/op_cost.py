"""Per-device cost of one step of the port, counted on ``meta`` tensors.

The counterpart of ``repro/launch/hlo_cost.py``.  The JAX dry run reads
a compiled, partitioned HLO module; the port has none, so it counts its
own step as it runs, eagerly, on ``meta`` tensors (nothing is allocated
and no card is opened).  :class:`CostMode` is a ``TorchDispatchMode``
that sees every aten op of the step and adds up, per device:

  flops       -- ``torch.utils.flop_counter``'s formulas (matrix
                 products), and for the two kernels of the path (their
                 ``meta_op``) the kernel's own work, ``work()`` in
                 ``kernels/flash_attention.py`` and ``linear_scan.py``:
                 the same reckoning as ``chip_smoke.py``'s bounds, never
                 the plain version's (B, H, T, S) scores;
  bytes       -- operand plus result bytes of each op that materializes
                 (views and fresh allocations are free; ``copy_`` reads
                 its source and writes its destination);
  peak_bytes  -- the peak of live tensor bytes: every storage from the
                 moment an op creates it (or the count begins, for the
                 parameters, optimizer state and inputs) until the last
                 tensor on it dies (autograd's saved tensors kept alive
                 through ``saved_tensors_hooks``).

Eager execution runs every layer, so there are no loop trip counts to
recover -- the reason ``hlo_cost.py`` exists falls away.  One microbatch
is run; its forward and backward count ``grad_accum`` times, the
optimizer update once.

**Per-device attribution.**  The step runs at the per-device
microbatch (the global batch over ``grad_accum`` and the DP ladder's
rung, ``dist.sharding.batch_axes_for``).  The weights are whole, so an
op's cost is divided by the ``model`` axis' size only where the plan
shards what it reads over ``model`` (:class:`Attribution`): a block's
ops (attention, MLP, MoE, RG-LRU, SSD, in forward, recompute and
backward, located by ``torch.utils.module_tracker``) when ``spec_for``
or ``qkv_specs`` shard the block's weight or heads, or the decode
cache's sequence; ops outside the blocks that touch a vocab-sized dim
when the vocab is sharded; the residual stream's norms and adds when
``act_spec`` shards its sequence.  Every other op is counted whole on
each device and named in the plan's ``fallbacks``.  In the optimizer
update an op is divided by the shard count of the leaf it reads (its
spec over every axis), as each device updates its shard; a parameter's
gradient is kept at its shard's bytes.

Collectives are reckoned from the plan (:func:`reckon_collectives`),
each listed by op, bytes, group size and axis.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import weakref
from typing import Any, Callable

import torch
# imported here, not lazily by the first checkpointed layer of a step:
# that import's frames would hold the step's tensors in a reference cycle
# and so move the first count's peak
import torch._dynamo  # noqa: F401
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.module_tracker import ModuleTracker

from ..dist import sharding as sh
from ..kernels import flash_attention as fa
from ..kernels import linear_scan as ls

aten = torch.ops.aten

# the kernels' meta ops: (flops, bytes) from the kernel's own reckoning
_KERNELS: dict[Any, Callable] = {
    torch.ops.repro_torch.flash_attention.default:
        lambda q, k, v, causal, window, lse: fa.work(
            q.shape, k.shape, q.dtype, causal=causal, window=window or None,
            return_lse=lse),
    torch.ops.repro_torch.linear_scan.default:
        lambda x, a, h0: ls.work(x.shape, x.dtype, h0 is not None),
}
# allocations: no bytes moved
_FREE = {aten.empty.memory_format, aten.empty_like.default,
         aten._unsafe_view.default,
         aten.empty_strided.default, aten.new_empty.default,
         aten.new_empty_strided.default}
_WRITE_ONLY = {aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default}

_BLOCKS = ("attn", "xattn", "mlp", "moe", "rglru", "ssd")


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of nested lists, tuples and dicts.  A loop, not a
    recursive closure: a closure that calls itself is a reference cycle,
    which would keep every tensor it collected alive until the cyclic
    collector runs and so move the peak."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a read or write of ``t`` touches: its elements, at most its
    storage (an expanded view reads each element once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def shard_count(plan: sh.Plan, spec, skip_batch_dims=()) -> int:
    """Devices one tensor of ``spec`` is split over (dims in
    ``skip_batch_dims`` not counted)."""
    n = 1
    for i, entry in enumerate(spec):
        if entry is None or i in skip_batch_dims:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n *= plan.size(a)
    return n


@dataclasses.dataclass
class Attribution:
    """How one cell's ops divide over the ``model`` axis (see the module
    docstring).  ``block``: divisor of each block kind's ops; ``vocab``:
    of ops outside the blocks that touch a vocab-sized dim; ``residual``:
    of the other ops outside the blocks."""
    model: int
    vocab_size: int
    block: dict[str, int]
    vocab: int
    residual: int

    @classmethod
    def of(cls, plan: sh.Plan, cfg, *, micro: int, seq: int, kind: str,
           decode_sharded: bool) -> "Attribution":
        from ..models import blocks
        from ..models.lm import LM

        m_axis = plan.model_axis
        m = plan.size(m_axis) if m_axis else 1

        def sharded(spec) -> bool:
            return m_axis is not None and any(
                m_axis in (e if isinstance(e, tuple) else (e,))
                for e in spec if e is not None)

        used = {blk for kind_ in cfg.pattern for blk in (
            ("attn", "moe" if cfg.n_experts else "mlp")
            if kind_ in ("attn", "local") else
            (("rglru", "mlp") if kind_ == "rglru" else ("ssd",)))}
        div: dict[str, int] = {}
        if "attn" in used:
            q, _, grp = sh.qkv_specs(plan, cfg, micro, seq=seq)
            attn = sharded(q) or sharded(grp)
            if kind == "decode":
                window = cfg.window if "local" in cfg.pattern else None
                cache = blocks.attn_cache_specs(cfg, micro, seq, cfg.dtype,
                                                window=window)
                attn = decode_sharded or sharded(
                    sh.spec_for(plan, cache["k"])[1:])
            div["attn"] = div["xattn"] = m if attn else 1
        for blk, spec_fn, name in (("mlp", blocks.mlp_specs, "w_gate"),
                                   ("moe", blocks.moe_specs, "w_gate"),
                                   ("rglru", blocks.rglru_specs, "w_x"),
                                   ("ssd", blocks.ssd_specs, "w_in")):
            if blk in used:
                div[blk] = m if sharded(
                    sh.spec_for(plan, spec_fn(cfg)[name])) else 1
        embed = LM.top_specs(cfg)["embed"]
        vocab = m if sharded(sh.spec_for(plan, embed)) else 1
        act = sh.act_spec(plan, micro, seq=seq, decode=kind == "decode")
        residual = m if sharded(act) else 1
        att = cls(model=m, vocab_size=cfg.vocab_size, block=div,
                  vocab=vocab, residual=residual)
        if m > 1:
            for blk in sorted(used):
                if div[blk] == 1:
                    plan.note_fallback(f"op_cost: {blk} ops counted whole "
                                       f"on each of model={m} devices")
            if vocab == 1:
                plan.note_fallback(f"op_cost: vocab ops counted whole on "
                                   f"each of model={m} devices")
            if residual == 1:
                plan.note_fallback(f"op_cost: residual-stream ops (norms, "
                                   f"adds) counted whole on each of "
                                   f"model={m} devices")
        return att


@dataclasses.dataclass
class Counts:
    """Per-device totals of a step."""
    flops: float = 0.0
    flops_by_dtype: dict[str, float] = dataclasses.field(default_factory=dict)
    bytes: float = 0.0
    ops: int = 0
    by_op: dict[str, list[float]] = dataclasses.field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float, dtype: str,
            times: float = 1.0) -> None:
        self.flops += flops * times
        self.bytes += nbytes * times
        self.ops += times
        if flops:
            self.flops_by_dtype[dtype] = \
                self.flops_by_dtype.get(dtype, 0.0) + flops * times
        rec = self.by_op.setdefault(name, [0.0, 0.0, 0.0])
        rec[0] += times
        rec[1] += flops * times
        rec[2] += nbytes * times

    def merge(self, other: "Counts", times: float = 1.0) -> None:
        for name, (n, f, b) in other.by_op.items():
            rec = self.by_op.setdefault(name, [0.0, 0.0, 0.0])
            rec[0] += n * times
            rec[1] += f * times
            rec[2] += b * times
        for k, v in other.flops_by_dtype.items():
            self.flops_by_dtype[k] = self.flops_by_dtype.get(k, 0.0) + \
                v * times
        self.flops += other.flops * times
        self.bytes += other.bytes * times
        self.ops += other.ops * times


class CostMode(TorchDispatchMode):
    """Counts flops and bytes of every op into ``self.phase`` (a
    :class:`Counts`) and tracks live storage bytes and their peak.

    ``attribution`` divides ops over the model axis; ``storage_div``
    maps a tensor shape to the shard count of a parameter (or optimizer
    state) leaf of that shape; ``update`` switches to the optimizer
    update's rule (an op divided by the shard count of the leaf it
    reads)."""

    def __init__(self, attribution: Attribution, storage_div: dict,
                 tracker: ModuleTracker):
        super().__init__()
        self.att = attribution
        self.storage_div = storage_div
        self.tracker = tracker
        self.phase = Counts()
        self.update = False
        self.live = 0.0
        self.peak = 0.0
        self._storages: dict[int, list] = {}    # cdata -> [refs, bytes]

    # -- liveness --------------------------------------------------------
    def track(self, t: torch.Tensor, divisor: float) -> None:
        """Count ``t``'s storage live (at ``1 / divisor`` of its bytes)
        until the last tracked tensor on it dies."""
        key = t.untyped_storage()._cdata
        rec = self._storages.get(key)
        if rec is None:
            nbytes = t.untyped_storage().nbytes() / divisor
            self._storages[key] = [1, nbytes]
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        else:
            rec[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        rec = self._storages.get(key)
        if rec is None:
            return
        rec[0] -= 1
        if rec[0] == 0:
            self.live -= rec[1]
            del self._storages[key]

    # -- attribution -----------------------------------------------------
    def _divisor(self, tensors: list[torch.Tensor]) -> float:
        att = self.att
        if self.update:
            for t in tensors:
                d = self.storage_div.get(tuple(t.shape))
                if d:
                    return d
            return 1
        for name in self.tracker.parents:
            blk = name.rsplit(".", 1)[-1]
            if blk in _BLOCKS:
                return att.block.get(blk, 1)
        if any(att.vocab_size in t.shape for t in tensors):
            return att.vocab
        return att.residual

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        div = self._divisor(ins + outs)
        if func in _KERNELS:
            flops, nbytes = _KERNELS[func](*args, **kwargs)
        else:
            flops = 0
            packet = func._overloadpacket
            if packet in flop_registry:
                flops = flop_registry[packet](*args, **kwargs, out_val=out)
            if func.is_view or func in _FREE:
                nbytes = 0
            elif func is aten.copy_.default:
                nbytes = _nbytes(args[0]) + _nbytes(args[1])
            elif func in _WRITE_ONLY:
                nbytes = _nbytes(args[0])
            else:
                nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        dtype = str(outs[0].dtype).removeprefix("torch.") if outs else ""
        self.phase.add(str(packet_name(func)), flops / div, nbytes / div,
                       dtype)
        for t in outs:
            sdiv = div
            if self.tracker.is_bw or self.update:
                sdiv = self.storage_div.get(tuple(t.shape), div)
            self.track(t, sdiv)
        return out


def packet_name(func) -> str:
    return str(func._overloadpacket).removeprefix("aten.")


def _pack(t):
    return t


def _unpack(t):
    return t


@dataclasses.dataclass
class StepCost:
    """One step's per-device cost: the counts, the live bytes when the
    count began (``arg_bytes``) and the peak."""
    counts: Counts
    arg_bytes: float
    peak_bytes: float

    def to_json(self) -> dict:
        top = sorted(self.counts.by_op.items(), key=lambda kv: -kv[1][2])
        return {"flops": self.counts.flops,
                "flops_by_dtype": self.counts.flops_by_dtype,
                "bytes": self.counts.bytes, "ops": self.counts.ops,
                "arg_bytes": self.arg_bytes, "peak_bytes": self.peak_bytes,
                "by_op": {k: {"count": n, "flops": f, "bytes": b}
                          for k, (n, f, b) in top[:24]}}


def count_step(step: Callable, args: tuple, *, attribution: Attribution,
               live: list[tuple[torch.Tensor, float]],
               storage_div: dict | None = None, grad_accum: int = 1,
               accum_bytes: float = 0.0) -> tuple[StepCost, Any]:
    """Run ``step(*args, on_grads)`` under :class:`CostMode`.

    ``live``: the tensors that exist before the step (parameters,
    optimizer state, inputs, caches), each with its shard count.
    ``on_grads`` is a gradient hook for a train step to pass as its
    ``compress_fn``: what runs before it (one microbatch's forward and
    backward) counts ``grad_accum`` times, what runs after it (the
    optimizer update) once; a serve step ignores it.  ``accum_bytes``:
    the gradient accumulator's per-device bytes, live across the
    microbatches when ``grad_accum > 1``.  Returns (the cost, the step's
    result)."""
    tracker = ModuleTracker()
    mode = CostMode(attribution, storage_div or {}, tracker)
    for t, div in live:
        mode.track(t, div)
    arg_bytes = mode.live
    grads = Counts()

    def on_grads(g):
        nonlocal grads
        grads, mode.phase = mode.phase, Counts()
        mode.update = True
        return g

    # the cyclic collector stays off during the step, so a storage's
    # death is its last reference's (deterministic, as on the card);
    # nothing here makes a cycle that holds a tensor
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        with tracker, mode, torch.autograd.graph.saved_tensors_hooks(
                _pack, _unpack):
            result = step(*args, on_grads)
    finally:
        if was_enabled:
            gc.enable()
    total = Counts()
    if mode.update:
        total.merge(grads, grad_accum)
        total.merge(mode.phase)
    else:
        total.merge(mode.phase)
    peak = mode.peak + (accum_bytes if grad_accum > 1 else 0.0)
    if grad_accum > 1:
        total.add("grad_accumulate", 0.0, 3.0 * accum_bytes, "",
                  times=grad_accum)
    del mode
    return StepCost(total, arg_bytes, peak), result


# ---------------------------------------------------------------------------
# collectives, reckoned from the plan
# ---------------------------------------------------------------------------

def _axis(axes) -> str:
    return ",".join(axes)


def reckon_collectives(plan: sh.Plan, cfg, att: Attribution, *, kind: str,
                       micro: int, b_dev: int, seq: int,
                       param_bytes_tp: float, param_bytes_fsdp: float,
                       decode_sharded: bool) -> list[dict]:
    """The collectives a step of ``kind`` needs on ``plan``'s mesh, per
    device, each as ``{"op", "what", "bytes", "group", "axis",
    "count"}`` (``bytes``: the per-device result of one call).

    - TP (``model``): one all-reduce of a block's (B, T, D) output per
      pass (forward, backward, and the remat recompute) for every block
      whose ops divide over ``model`` (MoE's combine is the ``psum`` of
      ``moe_shard_map``: the port's expert parallelism has no
      all-to-all); the vocab-sharded embedding's gather and head (the
      CE's three (B, T) statistics forward, the input gradient
      backward; at serving, the last position's logits gathered);
    - sharded decode: ``decode_attention_sharded``'s three combines per
      attention layer (``pmax`` of m, ``psum`` of l and of acc);
    - DP: the gradient all-reduce over the batch axes, or with FSDP the
      parameters' all-gather (forward and backward) and the gradients'
      reduce-scatter over ``data`` per microbatch, then an all-reduce
      over the other batch axes.
    """
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    d = cfg.d_model
    m = att.model
    train = kind == "train"
    t = 1 if kind == "decode" else seq
    passes = (2 + int(cfg.remat)) if train else 1
    accum = cfg.grad_accum if train else 1
    out: list[dict] = []

    def add(op, what, nbytes, group, axis, count):
        if group > 1 and count and nbytes:
            out.append({"op": op, "what": what, "bytes": float(nbytes),
                        "group": int(group), "axis": axis,
                        "count": int(count)})

    if m > 1:
        tokens = b_dev * t
        blocks: dict[str, int] = {}
        for k in cfg.pattern:
            names = (("attn", "moe" if cfg.n_experts else "mlp")
                     if k in ("attn", "local") else
                     (("rglru", "mlp") if k == "rglru" else ("ssd",)))
            for b in names:
                blocks[b] = blocks.get(b, 0) + 1
        if cfg.encoder_layers:
            blocks["xattn"] = cfg.n_layers
            enc = cfg.encoder_layers
        for b, n in sorted(blocks.items()):
            if att.block.get(b, 1) > 1:
                add("all-reduce", f"{b} output (TP)", tokens * d * item, m,
                    "model", n * passes * accum)
        if cfg.encoder_layers and att.block.get("attn", 1) > 1:
            enc_tokens = b_dev * cfg.frontend_tokens
            add("all-reduce", "encoder attn + mlp outputs (TP)",
                enc_tokens * d * item, m, "model",
                2 * enc * passes * accum)
        if att.vocab > 1:
            add("all-reduce", "embedding gather (TP vocab)",
                tokens * d * item, m, "model", accum)
            if train:
                add("all-reduce", "CE statistics (TP vocab)", tokens * 4, m,
                    "model", 3 * accum)
                add("all-reduce", "head input gradient (TP vocab)",
                    tokens * d * item, m, "model", accum)
            else:
                add("all-gather", "last logits (TP vocab)",
                    b_dev * cfg.vocab_size * item, m, "model", 1)
        if decode_sharded:
            n_attn = sum(k in ("attn", "local") for k in cfg.pattern)
            g = cfg.n_heads // cfg.n_kv_heads
            stat = b_dev * cfg.n_kv_heads * g * 4
            add("all-reduce", "sharded decode pmax(m)", stat, m, "model",
                n_attn)
            add("all-reduce", "sharded decode psum(l)", stat, m, "model",
                n_attn)
            add("all-reduce", "sharded decode psum(acc)",
                stat * cfg.resolved_head_dim, m, "model", n_attn)
    if train:
        axes = sh.batch_axes_for(plan, micro)
        dp = math.prod(plan.size(a) for a in axes)
        if plan.fsdp and "data" in axes and plan.size("data") > 1:
            data = plan.size("data")
            rest = tuple(a for a in axes if a != "data")
            whole = param_bytes_tp - param_bytes_fsdp    # not over data
            add("all-gather", "FSDP parameters (forward, backward)",
                param_bytes_fsdp, data, "data", 2 * accum)
            add("reduce-scatter", "FSDP gradients",
                param_bytes_fsdp / data, data, "data", accum)
            add("all-reduce", "gradients of parameters not over data",
                whole, data, "data", 1)
            add("all-reduce", "gradients over the other batch axes",
                param_bytes_fsdp / data + whole,
                math.prod(plan.size(a) for a in rest), _axis(rest), 1)
        else:
            add("all-reduce", "DP gradients", param_bytes_tp, dp,
                _axis(axes), 1)
    return out


__all__ = ["Attribution", "CostMode", "Counts", "StepCost", "count_step",
           "reckon_collectives", "shard_count"]
