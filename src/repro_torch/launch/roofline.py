"""Roofline terms of one dry-run cell, against the H100's peaks.

The H100 counterpart of ``repro/launch/roofline.py``.  Three terms per
(arch x shape x mesh) cell, all in seconds (a lower bound on the step
time if that resource were the only one):

  compute    = flops_per_device / the peak of their type (bf16 on the
               tensor cores, float32 on the CUDA cores: TF32 is off)
  memory     = bytes_per_device / HBM_BW
  collective = sum over collectives of link_bytes / the bandwidth of the
               mesh axis it runs over (NVLink for ``model``, InfiniBand
               for ``data`` and ``pod``; a collective over several axes
               runs at the slowest)

The per-device flops and bytes come from ``launch/op_cost.py`` (the
port's counterpart of counting the partitioned HLO), the collectives
from the plan (``op_cost.reckon_collectives``).  Each collective's link
bytes follow the standard ring models (per device):

  all-gather          result_bytes * (g-1)/g
  all-reduce          2 * result_bytes * (g-1)/g     (reduce-scatter + AG)
  reduce-scatter      result_bytes * (g-1)            (operand = result * g)
  all-to-all          result_bytes * (g-1)/g
  collective-permute  result_bytes

where ``g`` is the group size.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from .mesh import AXIS_BW, HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32

# the peak rate of each type's flops
_PEAK = {"bfloat16": PEAK_FLOPS_BF16, "float16": PEAK_FLOPS_BF16}


def ring_bytes(op: str, nbytes: float, g: int) -> float:
    """Bytes one device moves over links for one collective ``op`` with a
    result of ``nbytes`` per device in a group of ``g``."""
    if op == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(nbytes) * (g - 1)
    if op == "collective-permute":
        return float(nbytes)
    if op in ("all-gather", "all-to-all"):
        return float(nbytes) * (g - 1) / g
    raise ValueError(f"unknown collective {op!r}")


def axis_bandwidth(axis: str) -> float:
    """The link rate of a collective over ``axis`` ("a,b": several)."""
    return min(AXIS_BW[a] for a in axis.split(","))


@dataclasses.dataclass
class CollectiveStats:
    ops: dict[str, int]
    link_bytes: float                # per device, ring-model
    result_bytes: float              # raw sum of collective result sizes
    by_op: dict[str, float]

    def to_json(self):
        return dataclasses.asdict(self)


def collective_stats(entries: list[dict]) -> CollectiveStats:
    """Sums of ``op_cost.reckon_collectives``'s entries (each ``count``
    times)."""
    ops: dict[str, int] = {}
    by_op: dict[str, float] = {}
    link = raw = 0.0
    for e in entries:
        moved = ring_bytes(e["op"], e["bytes"], e["group"]) * e["count"]
        ops[e["op"]] = ops.get(e["op"], 0) + e["count"]
        by_op[e["op"]] = by_op.get(e["op"], 0.0) + moved
        link += moved
        raw += e["bytes"] * e["count"]
    return CollectiveStats(ops=ops, link_bytes=link, result_bytes=raw,
                           by_op=by_op)


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    link_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float               # 6ND (train) / 2ND (serve), global
    useful_flops_ratio: float        # model_flops/chips / counted flops
    roofline_fraction: float         # ideal_compute / max(all terms)
    collectives: dict[str, Any]
    memory_analysis: dict[str, float]

    def to_json(self):
        return dataclasses.asdict(self)


def analyze(counts: dict, collectives: list[dict], *, n_chips: int,
            model_flops: float) -> Roofline:
    """The roofline of one cell from ``op_cost``'s per-device counts
    (``StepCost.to_json()``: ``flops_by_dtype``, ``bytes``,
    ``arg_bytes``, ``peak_bytes``) and its collectives, in place of a
    compiled XLA executable."""
    flops = float(counts["flops"])
    nbytes = float(counts["bytes"])
    compute_s = sum(f / _PEAK.get(dt, PEAK_FLOPS_F32)
                    for dt, f in counts["flops_by_dtype"].items())
    memory_s = nbytes / HBM_BW
    cs = collective_stats(collectives)
    coll_s = sum(ring_bytes(e["op"], e["bytes"], e["group"]) * e["count"]
                 / axis_bandwidth(e["axis"]) for e in collectives)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    bottleneck = max(terms, key=terms.get)  # type: ignore[arg-type]
    ideal = (model_flops / n_chips) / PEAK_FLOPS_BF16
    worst = max(terms.values())
    peak = float(counts["peak_bytes"])
    args = float(counts["arg_bytes"])
    mem_d = {"argument_bytes": args, "output_bytes": 0.0,
             "temp_bytes": peak - args, "alias_bytes": 0.0,
             "peak_bytes": peak}
    return Roofline(
        flops_per_device=flops, bytes_per_device=nbytes,
        link_bytes_per_device=cs.link_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_flops_ratio=(model_flops / n_chips) / flops if flops else 0.0,
        roofline_fraction=ideal / worst if worst else 0.0,
        collectives={**cs.to_json(), "list": collectives},
        memory_analysis=mem_d)


def model_flops_estimate(cfg, batch: int, seq: int, kind: str) -> float:
    """MODEL_FLOPS: 6*N*D (train) or 2*N*D (forward), N = active params.

    For decode, D = batch tokens (one step) and attention adds
    2 * layers * kv_bytes-equivalent reads -- we report the matmul-model
    number (the standard MFU convention) and let useful_flops_ratio carry
    the gap.
    """
    n = cfg.n_active_params
    tokens = batch * seq
    if kind == "train":
        return 6.0 * n * tokens
    if kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * batch            # decode: one token per sequence


__all__ = ["CollectiveStats", "Roofline", "analyze", "axis_bandwidth",
           "collective_stats", "model_flops_estimate", "ring_bytes"]
