"""Execution backends: *where* subset evaluations run.

The paper's algorithms are backend-agnostic -- every step of E.FSP / G.FSP
reduces to "evaluate ``#Edges(SP', C, G)`` for candidate subsets SP'".
A backend owns the execution substrate behind two methods:

* ``evaluate(store, class_id, props, n_s, am)`` -- one candidate subset
  (Def. 4.8 objective), exact host arithmetic.
* ``workspace(store, class_id, props, n_s, am)`` -- a per-(class, descent)
  :class:`repro_torch.core.sweep.SweepWorkspace`: the object matrix is
  extracted ONCE, the device backend uploads it ONCE, and every candidate
  batch is served from that parent buffer.

==========  =================================================================
``host``    the paper's sequential numpy loop (reference semantics)
``device``  one batched torch launch sequence per sweep on ``device``
            (default ``"cuda"``: the hand CUDA kernels); ``device="cpu"``
            runs the same path on the kernels' plain versions
==========  =================================================================
"""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

from ..core.star import StarSweepResult, evaluate_subset
from ..core.sweep import (DeviceSweepWorkspace, HostSweepWorkspace,
                          SweepWorkspace)
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
                  props: Sequence[int], n_s: int, am: int) -> SweepWorkspace:
        ...


class HostBackend:
    """The paper-faithful sequential numpy path."""

    name = "host"

    def evaluate(self, store, class_id, props, n_s, am):
        return evaluate_subset(store, class_id, props, n_s, am)

    def workspace(self, store, class_id, props, n_s, am):
        return HostSweepWorkspace(store, class_id, props, n_s, am)


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

    def workspace(self, store, class_id, props, n_s, am):
        return DeviceSweepWorkspace(store, class_id, props, n_s, am,
                                    device=self.device)


BACKENDS = Registry("execution backend")
BACKENDS.register("host", HostBackend)
BACKENDS.register("device", DeviceBackend)


def get_backend(spec, **opts) -> ExecutionBackend:
    """Resolve a backend: a registered name (instantiated with ``opts``)
    or an already-constructed backend instance (returned as-is)."""
    if isinstance(spec, str):
        return BACKENDS.get(spec)(**opts)
    if isinstance(spec, ExecutionBackend):
        return spec
    raise TypeError(f"not an execution backend: {spec!r}")
