"""Execution backends: *where* subset evaluations run.

The paper's algorithms are backend-agnostic -- every step of E.FSP / G.FSP
reduces to "evaluate ``#Edges(SP', C, G)`` for candidate subsets SP'".
A backend owns the execution substrate behind two methods:

* ``evaluate(store, class_id, props, n_s, am)`` -- one candidate subset
  (Def. 4.8 objective), exact host arithmetic.
* ``workspace(store, class_id, props, n_s, am, objective)`` -- a
  per-(class, descent) :class:`repro_torch.core.sweep.SweepWorkspace`
  scoring ``objective`` (``core.sweep.OBJECTIVES``): the object matrix
  is extracted ONCE, the device backend uploads it ONCE, and every
  candidate batch is served from that parent buffer.

==========  =================================================================
``host``    the paper's sequential numpy loop (reference semantics)
``device``  one batched torch launch sequence per sweep on ``device``
            (default ``"cuda"``: the hand CUDA kernels); ``device="cpu"``
            runs the same path on the kernels' plain versions
``sharded`` the bucketed sweep with rows sharded over the mesh's
            data-parallel axes (a :mod:`repro_torch.dist.mesh` mesh of
            torch devices), layout routed through
            ``repro_torch.dist.sharding.make_plan``
==========  =================================================================
"""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

from ..core.star import StarSweepResult, evaluate_subset
from ..core.sweep import (DeviceSweepWorkspace, HostSweepWorkspace,
                          ShardedSweepWorkspace, SweepWorkspace)
from ..core.triples import TripleStore
from ..kernels.ops import resolve_device
from ..registry import Registry


@runtime_checkable
class ExecutionBackend(Protocol):
    """Strategy protocol: where candidate-subset evaluations execute."""

    name: str

    def evaluate(self, store: TripleStore, class_id: int,
                 props: Sequence[int], n_s: int, am: int) -> StarSweepResult:
        ...

    def workspace(self, store: TripleStore, class_id: int,
                  props: Sequence[int], n_s: int, am: int,
                  objective: str = "folded") -> SweepWorkspace:
        ...


class HostBackend:
    """The paper-faithful sequential numpy path."""

    name = "host"

    def evaluate(self, store, class_id, props, n_s, am):
        return evaluate_subset(store, class_id, props, n_s, am)

    def workspace(self, store, class_id, props, n_s, am,
                  objective="folded"):
        return HostSweepWorkspace(store, class_id, props, n_s, am,
                                  objective)


class DeviceBackend:
    """Batched torch sweep: all candidates of a sweep in one launch
    sequence on ``device``.  Raises at construction when ``device`` is
    CUDA and no card is present."""

    name = "device"

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)

    def evaluate(self, store, class_id, props, n_s, am):
        # single-subset evaluation is cheaper (and exact) on host
        return evaluate_subset(store, class_id, props, n_s, am)

    def workspace(self, store, class_id, props, n_s, am,
                  objective="folded"):
        return DeviceSweepWorkspace(store, class_id, props, n_s, am,
                                    objective, device=self.device)


class ShardedBackend:
    """Bucketed sweep with the object matrix row-sharded over a mesh.

    Layout policy is routed through the ``repro_torch.dist`` planner: the
    mesh's data-parallel axes come from ``sharding.make_plan`` (DP
    ladder, tensor-parallel axis excluded), rows are bucket-padded to the
    DP degree and placed one block per DP coordinate on its device, and
    padding rows are masked out of the distinct-signature count.  With
    ``mesh=None`` this is the single-device bucketed sweep on ``device``
    (same bucket ladder, same counters).

    On a mesh the WHOLE candidate stack of a sweep runs through
    ``core.distributed.ami_bucketed_batch`` -- the hash-bucket exchange
    with a leading candidate axis, one launch sequence per descent.  The
    mesh's entries carry the devices; a CUDA entry raises without a card
    when the mesh is made (``dist.mesh.make_mesh``).
    """

    name = "sharded"

    def __init__(self, mesh=None, device="cuda") -> None:
        self.mesh = mesh
        self.plan = None
        # on a mesh its entries carry the devices (the first stands in
        # for the workspace's own)
        self.device = (resolve_device(device) if mesh is None
                       else mesh.devices.flat[0])
        if mesh is not None:
            from ..dist import sharding as dsh
            # the "model" axis is reserved: FSP rows shard over the
            # data-parallel axes only
            self.plan = dsh.make_plan(mesh)

    def evaluate(self, store, class_id, props, n_s, am):
        return evaluate_subset(store, class_id, props, n_s, am)

    def workspace(self, store, class_id, props, n_s, am,
                  objective="folded"):
        return ShardedSweepWorkspace(store, class_id, props, n_s, am,
                                     objective, mesh=self.mesh,
                                     plan=self.plan, device=self.device)


BACKENDS = Registry("execution backend")
BACKENDS.register("host", HostBackend)
BACKENDS.register("device", DeviceBackend)
BACKENDS.register("sharded", ShardedBackend)


def register_backend(name: str, cls) -> None:
    BACKENDS.register(name, cls)


def get_backend(spec, **opts) -> ExecutionBackend:
    """Resolve a backend: a registered name (instantiated with ``opts``)
    or an already-constructed backend instance (returned as-is)."""
    if isinstance(spec, str):
        return BACKENDS.get(spec)(**opts)
    if isinstance(spec, ExecutionBackend):
        return spec
    raise TypeError(f"not an execution backend: {spec!r}")
