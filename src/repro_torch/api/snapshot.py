"""Immutable versioned snapshots plus the planner that builds them.

* :class:`GraphSnapshot` -- an immutable view of the compact form: one
  :class:`~repro_torch.core.fgraph.FactorizedGraph` and its digest.
* :class:`CompactionPlanner` -- the compaction brain: ``plan`` ranks
  classes by predicted Def. 4.8 savings through the configured detector
  and backend, ``execute`` factorizes a plan (Algorithm 3) into a fresh
  snapshot, ``run`` does both.  The incremental paths (``apply_update``,
  ``apply_delete``, ``redetect``) are a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Iterable, Sequence

import numpy as np

from ..core.factorize import FactorizationResult, factorize_classes
from ..core.fgraph import FactorizedGraph
from ..core.gfsp import FSPResult
from ..core.index import GraphIndex
from ..core.triples import TripleStore
from .backends import ExecutionBackend, get_backend
from .detectors import Detector, get_detector


# ---------------------------------------------------------------------------
# plan / report dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClassPlan:
    """One planned (class, SP) factorization with its predicted payoff.

    The predictions are filled by the auto-planner; explicit plans carry
    ``None`` (the caller already decided, so no evaluation is spent).
    """

    class_id: int
    props: tuple[int, ...]
    predicted_edges: int | None = None   # #Edges(SP, C, G) -- Def. 4.8
    baseline_edges: int | None = None    # #Edges(emptyset) = AM_G(C) * |S|
    detection: FSPResult | None = None

    @property
    def predicted_savings(self) -> int | None:
        if self.predicted_edges is None or self.baseline_edges is None:
            return None
        return self.baseline_edges - self.predicted_edges

    @property
    def pct_predicted_savings(self) -> float:
        savings = self.predicted_savings
        if not self.baseline_edges or savings is None:
            return 0.0
        return 100.0 * savings / self.baseline_edges


@dataclasses.dataclass
class CompactionPlan:
    """Ranked multi-class factorization plan (highest predicted savings
    first for auto-plans; given order for explicit plans)."""

    entries: list[ClassPlan]
    detector: str = "explicit"
    backend: str = "host"

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __bool__(self) -> bool:
        return bool(self.entries)

    @classmethod
    def explicit(cls, pairs: Sequence[tuple[int, Sequence[int]]]
                 ) -> "CompactionPlan":
        """Plan from caller-chosen (class_id, props) pairs, applied in the
        given order (no ranking, no savings filter, no detection cost)."""
        entries = [ClassPlan(class_id=int(cid),
                             props=tuple(sorted(int(p) for p in props)))
                   for cid, props in pairs]
        return cls(entries=entries, detector="explicit", backend="host")


@dataclasses.dataclass
class CompactionReport:
    """Outcome of one transactional multi-class compaction."""

    graph: TripleStore
    plan: CompactionPlan
    factorizations: list[FactorizationResult]
    n_triples_before: int
    n_triples_after: int
    exec_time_ms: float
    fgraph: FactorizedGraph | None = None   # the structured G' (queryable)

    @property
    def pct_savings_triples(self) -> float:
        if self.n_triples_before == 0:
            return 0.0
        return 100.0 * (self.n_triples_before - self.n_triples_after) \
            / self.n_triples_before

    @property
    def detections(self) -> dict[int, FSPResult]:
        return {e.class_id: e.detection for e in self.plan
                if e.detection is not None}

    def factorization_for(self, class_id: int) -> FactorizationResult:
        for f in self.factorizations:
            if f.class_id == class_id:
                return f
        raise KeyError(class_id)


# ---------------------------------------------------------------------------
# the snapshot
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class GraphSnapshot:
    """Immutable view of the compact form: one :class:`FactorizedGraph`
    (tables + instanceOf CSR + the store's ``GraphIndex``)."""

    fgraph: FactorizedGraph
    # one-slot memo for ``digest()`` -- a mutable cell so the frozen
    # dataclass can fill it lazily
    _digest_cache: list = dataclasses.field(
        default_factory=list, init=False, repr=False, compare=False)

    @property
    def store(self) -> TripleStore:
        return self.fgraph.store

    @property
    def index(self) -> GraphIndex:
        return self.fgraph.store.index

    @property
    def n_triples(self) -> int:
        return self.fgraph.n_triples

    def digest(self) -> str:
        """sha1 of the *semantic* graph (``expand()``, canonical row
        order), first 16 hex digits -- two snapshots with equal digests
        represent the same RDF graph however they are factorized.
        Cached per snapshot."""
        if not self._digest_cache:
            self._digest_cache.append(hashlib.sha1(
                np.ascontiguousarray(self.fgraph.expand().spo).tobytes()
            ).hexdigest()[:16])
        return self._digest_cache[0]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"GraphSnapshot(n_triples={self.n_triples}, "
                f"classes={len(self.fgraph.tables)})")


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

class CompactionPlanner:
    """Detect/plan/factorize over snapshots.

    The planner holds only configuration (detector, backend, thresholds);
    all graph state lives in the snapshots, which is what makes the
    owner's commit an atomic reference swap.
    """

    def __init__(self, detector: str | Detector = "gfsp",
                 backend: str | ExecutionBackend = "host", *,
                 min_predicted_savings: int = 1,
                 surrogate_prefix: str = "repro:sg",
                 detector_opts: dict | None = None,
                 backend_opts: dict | None = None) -> None:
        self.detector = get_detector(detector, **(detector_opts or {}))
        self.backend = get_backend(backend, **(backend_opts or {}))
        self.min_predicted_savings = min_predicted_savings
        self.surrogate_prefix = surrogate_prefix

    def detect(self, store: TripleStore, class_id: int,
               props: Sequence[int] | None = None) -> FSPResult:
        """Run the configured detector on one class."""
        return self.detector.detect(store, int(class_id),
                                    backend=self.backend, props=props)

    def plan(self, store: TripleStore,
             classes: Iterable[int] | None = None) -> CompactionPlan:
        """Rank all (or the given) classes by predicted #Edges savings."""
        cids = ([int(c) for c in classes] if classes is not None
                else [int(c) for c in store.classes()])
        entries = []
        for cid in cids:
            stats = store.class_stats(cid)
            n_s = int(stats.properties.shape[0])
            am = stats.n_instances
            if n_s < 2 or am == 0:
                continue                      # nothing star-shaped to share
            res = self.detect(store, cid)
            if len(res.props) < 2:
                continue
            entry = ClassPlan(class_id=cid, props=tuple(sorted(res.props)),
                              predicted_edges=res.edges,
                              baseline_edges=am * n_s, detection=res)
            if entry.predicted_savings >= self.min_predicted_savings:
                entries.append(entry)
        entries.sort(key=lambda e: -e.predicted_savings)
        return CompactionPlan(entries=entries, detector=self.detector.name,
                              backend=self.backend.name)

    def execute(self, store: TripleStore, plan: CompactionPlan
                ) -> tuple[GraphSnapshot, CompactionReport]:
        """Factorize every planned class transactionally into a fresh
        snapshot.  The input store is never mutated."""
        t0 = time.perf_counter()
        pairs = [(e.class_id, e.props) for e in plan]
        graph, results = factorize_classes(
            store, pairs, surrogate_prefix=self.surrogate_prefix)
        # star_objects rows are aligned with surrogates and ordered over
        # sorted props -- the molecule tables build with no rescan of G'
        fg = FactorizedGraph.from_compaction(graph, results)
        snap = GraphSnapshot(fgraph=fg)
        report = CompactionReport(
            graph=graph, plan=plan, factorizations=results,
            n_triples_before=store.n_triples, n_triples_after=graph.n_triples,
            exec_time_ms=(time.perf_counter() - t0) * 1e3,
            fgraph=fg)
        return snap, report

    def run(self, store: TripleStore,
            classes: Iterable[int] | None = None
            ) -> tuple[GraphSnapshot, CompactionReport]:
        """plan + execute in one call (the common entry point)."""
        return self.execute(store, self.plan(store, classes))


__all__ = ["ClassPlan", "CompactionPlan", "CompactionReport",
           "GraphSnapshot", "CompactionPlanner"]
