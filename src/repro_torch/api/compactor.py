"""The compaction pipeline: plan -> execute.

``Compactor`` is the public surface over the paper's algorithms
(detect-FSP -> factorize):

    comp = Compactor(detector="gfsp", backend="device")   # runs on CUDA
    report = comp.run(store)          # auto-plans every class, factorizes
    report.graph                      # G' (original store untouched)
    comp.run(store.compressed(), stream=True)   # the bit-packed tier,
                                      # one class's decodes at a time
    comp.update(new_triples)          # streaming inserts, no recomputation
    comp.delete(entities=[...])       # deletes, payoff-sweep decompaction
    comp.redetect([class_id])         # re-detect drifted classes only

It is a thin facade: all graph state lives in an immutable
:class:`~repro_torch.api.snapshot.GraphSnapshot` built by a
:class:`~repro_torch.api.snapshot.CompactionPlanner`, and the facade
commits each transform by swapping its one reference, so a reader
holding ``comp.snapshot`` never observes torn state.
"""
from __future__ import annotations

from typing import Iterable, Sequence

from ..core.fgraph import FactorizedGraph
from ..core.gfsp import FSPResult
from ..core.triples import TripleStore
from .backends import ExecutionBackend
from .detectors import Detector
from .snapshot import (ClassPlan, CompactionPlan, CompactionPlanner,  # noqa: F401
                       CompactionReport, DeleteReport, GraphSnapshot,
                       RedetectReport, UpdateReport)


class Compactor:
    """Configurable detect -> plan -> factorize pipeline (Algorithms 1-3).

    ``detector``/``backend`` accept registered names ("gfsp"/"efsp"/
    "gspan", "host"/"device") or constructed strategy instances;
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

    @property
    def min_predicted_savings(self) -> int:
        return self.planner.min_predicted_savings

    @property
    def surrogate_prefix(self) -> str:
        return self.planner.surrogate_prefix

    def detect(self, store: TripleStore, class_id: int,
               props: Sequence[int] | None = None) -> FSPResult:
        """Run the configured detector on one class."""
        return self.planner.detect(store, class_id, props=props)

    def plan(self, store: TripleStore,
             classes: Iterable[int] | None = None, *,
             stream: bool = False) -> CompactionPlan:
        """Rank all (or the given) classes by predicted #Edges savings.
        ``stream=True`` drops the store's transient decode caches
        between classes (see :meth:`CompactionPlanner.plan`)."""
        return self.planner.plan(store, classes, stream=stream)

    def execute(self, store: TripleStore,
                plan: CompactionPlan) -> CompactionReport:
        """Factorize every planned class transactionally; the snapshot
        swaps in only after all classes succeed."""
        snap, report = self.planner.execute(store, plan)
        self._snapshot = snap
        return report

    def run(self, store: TripleStore,
            classes: Iterable[int] | None = None, *,
            stream: bool = False) -> CompactionReport:
        """plan + execute in one call (the common entry point)."""
        return self.execute(store, self.plan(store, classes, stream=stream))

    @property
    def snapshot(self) -> GraphSnapshot:
        """The committed immutable snapshot (fgraph + epoch)."""
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

    # -- incremental path --------------------------------------------------
    def update(self, new_triples) -> UpdateReport:
        """Absorb streaming inserts into the factorized graph.

        ``new_triples``: an (n, 3) id array (shared dictionary) or an
        iterable of (subject, property, object) term triples.  New
        entities of factorized classes whose object tuple matches an
        existing star pattern are linked to its surrogate; novel tuples
        mint fresh surrogates (continuing per-class ordinals); incomplete
        molecules and unplanned classes stay raw.  No full recomputation.
        The successor snapshot commits atomically at the end.
        """
        snap, report = self.planner.apply_update(self.snapshot, new_triples)
        self._snapshot = snap
        return report

    def delete(self, triples=None, entities=None) -> DeleteReport:
        """Remove semantic triples and/or entities from the factorized
        graph transactionally (see :meth:`CompactionPlanner.apply_delete`);
        the successor snapshot commits only if every step succeeds."""
        snap, report = self.planner.apply_delete(
            self.snapshot, triples=triples, entities=entities)
        self._snapshot = snap
        return report

    def redetect(self, class_ids: Iterable[int]) -> RedetectReport:
        """Re-detect and re-factorize only the given (drifted) classes;
        see :meth:`CompactionPlanner.redetect`."""
        snap, report = self.planner.redetect(self.snapshot, class_ids)
        self._snapshot = snap
        return report
