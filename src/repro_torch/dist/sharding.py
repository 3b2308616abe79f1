"""Sharding planner: which mesh axes carry the batch (row) dimension.

The port's copy of the part of ``repro/dist/sharding.py`` that the
sharded compaction path reads: :class:`Plan`, :func:`make_plan` and
:func:`batch_axes_for`.  ``ShardedBackend`` builds a plan from its mesh
(tensor-parallel on, so the ``model`` axis is reserved and rows shard
over the data-parallel axes), and ``ShardedSweepWorkspace`` asks
``batch_axes_for`` which axes its bucket-padded rows shard over.

Batch dims use the DP ladder: the widest rung of the mesh's
data-parallel axes (every axis but ``model``, the tensor-parallel one)
whose total size divides the batch, giving up ``pod`` first, so plain
``data`` sharding survives the smallest batches.

The LM's layout policy (the ``cfg`` switches ``tp``, ``fsdp`` and
``seq_shard``, the fallbacks, and the tensor-spec rules ``spec_for``,
``act_spec``, ``qkv_specs`` and the optimizer- and train-state
shardings) waits for the training slice of the port, which is the first
to place model tensors on a mesh.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Plan:
    """Which mesh axes carry the rows of one mesh."""
    axis_sizes: dict[str, int]
    dp_axes: tuple[str, ...]      # mesh axes available for batch sharding
    ladder: tuple[tuple[str, ...], ...]   # DP rungs, widest first

    def size(self, axis: str) -> int:
        return self.axis_sizes.get(axis, 1)


def make_plan(mesh) -> Plan:
    """Build a plan from any mesh-like object exposing ``.devices``
    (ndarray) and ``.axis_names``; the rule logic itself is
    device-free.  The ``model`` axis is reserved for tensor parallel
    (``repro``'s ``make_plan`` with ``cfg.tp`` on)."""
    names = tuple(mesh.axis_names)
    sizes = dict(zip(names, mesh.devices.shape))
    dp = tuple(n for n in names if n != "model")

    # DP ladder: sacrifice "pod" first; "data" dies last
    rungs = [dp]
    if "pod" in dp:
        rungs.append(tuple(a for a in dp if a != "pod"))
    if rungs[-1]:
        rungs.append(())
    return Plan(axis_sizes=sizes, dp_axes=dp, ladder=tuple(rungs))


def batch_axes_for(plan: Plan, batch: int) -> tuple[str, ...]:
    """Widest DP rung whose device count divides ``batch``."""
    for rung in plan.ladder:
        n = 1
        for a in rung:
            n *= plan.size(a)
        if n and batch % n == 0:
            return rung
    return ()


__all__ = ["Plan", "make_plan", "batch_axes_for"]
