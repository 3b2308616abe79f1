"""The compaction pipeline: plan -> execute.

``Compactor`` is the public surface over the paper's algorithms
(detect-FSP -> factorize):

    comp = Compactor(detector="gfsp", backend="device")   # runs on CUDA
    report = comp.run(store)          # auto-plans every class, factorizes
    report.graph                      # G' (original store untouched)

It is a thin facade: all graph state lives in an immutable
:class:`~repro_torch.api.snapshot.GraphSnapshot` built by a
:class:`~repro_torch.api.snapshot.CompactionPlanner`, and the facade
commits by swapping its one reference.  ``update``, ``delete`` and
``redetect`` are a later slice of the port.
"""
from __future__ import annotations

from typing import Iterable, Sequence

from ..core.fgraph import FactorizedGraph
from ..core.gfsp import FSPResult
from ..core.triples import TripleStore
from .backends import ExecutionBackend
from .detectors import Detector
from .snapshot import (ClassPlan, CompactionPlan, CompactionPlanner,  # noqa: F401
                       CompactionReport, GraphSnapshot)


class Compactor:
    """Configurable detect -> plan -> factorize pipeline (Algorithms 1-3).

    ``detector``/``backend`` accept registered names ("gfsp"/"efsp",
    "host"/"device") or constructed strategy instances;
    ``detector_opts``/``backend_opts`` are forwarded when a name is given
    (e.g. ``backend="device", backend_opts={"device": "cpu"}``).
    """

    def __init__(self, detector: str | Detector = "gfsp",
                 backend: str | ExecutionBackend = "host", *,
                 min_predicted_savings: int = 1,
                 surrogate_prefix: str = "repro:sg",
                 detector_opts: dict | None = None,
                 backend_opts: dict | None = None) -> None:
        self.planner = CompactionPlanner(
            detector, backend,
            min_predicted_savings=min_predicted_savings,
            surrogate_prefix=surrogate_prefix,
            detector_opts=detector_opts, backend_opts=backend_opts)
        self._snapshot: GraphSnapshot | None = None

    @property
    def detector(self) -> Detector:
        return self.planner.detector

    @property
    def backend(self) -> ExecutionBackend:
        return self.planner.backend

    def detect(self, store: TripleStore, class_id: int,
               props: Sequence[int] | None = None) -> FSPResult:
        """Run the configured detector on one class."""
        return self.planner.detect(store, class_id, props=props)

    def plan(self, store: TripleStore,
             classes: Iterable[int] | None = None) -> CompactionPlan:
        """Rank all (or the given) classes by predicted #Edges savings."""
        return self.planner.plan(store, classes)

    def execute(self, store: TripleStore,
                plan: CompactionPlan) -> CompactionReport:
        """Factorize every planned class transactionally; the snapshot
        swaps in only after all classes succeed."""
        snap, report = self.planner.execute(store, plan)
        self._snapshot = snap
        return report

    def run(self, store: TripleStore,
            classes: Iterable[int] | None = None) -> CompactionReport:
        """plan + execute in one call (the common entry point)."""
        return self.execute(store, self.plan(store, classes))

    @property
    def snapshot(self) -> GraphSnapshot:
        """The committed immutable snapshot."""
        if self._snapshot is None:
            raise RuntimeError("Compactor.run()/execute() before .snapshot")
        return self._snapshot

    @property
    def fgraph(self) -> FactorizedGraph:
        """The committed factorized graph (molecule tables + CSR)."""
        return self.snapshot.fgraph

    @property
    def graph(self) -> TripleStore:
        return self.fgraph.store
