"""Detector strategies: *which algorithm* finds the frequent star pattern.

A ``Detector`` maps ``(store, class_id)`` to the paper's ``FSPResult``
(best property subset SP, its Def. 4.8 ``#Edges`` value, AMI, and the
materialized star patterns):

``gfsp``   Algorithm 2, the greedy one-property-removed descent.
           Backend-parametric: every per-sweep candidate batch runs on the
           configured ``ExecutionBackend`` (host loop / batched device).
``efsp``   Algorithm 1, the exhaustive breadth-first scan over the
           property-subset lattice: each lattice level (all ``C(n, j)``
           size-j subsets) is ONE candidate batch through
           ``SweepWorkspace.sweep_candidates``.  ``min_support > 1`` or
           a pre-built ``subgraphs_dict`` selects the legacy
           gSpan-counted scan instead.
``gspan``  the honest gSpan-cost baseline: the full pattern space is
           enumerated (exponential, as the paper's Table 3 measures) and
           only mined property subsets are scored.  With complete
           molecules the detected SP coincides with efsp/gfsp.

The gSpan-counted paths consume pre-counted pattern multiplicities on the
host, so their results are backend-independent; they accept the backend
argument to keep ``Compactor`` wiring uniform.

``gfsp`` and ``efsp`` take ``objective`` (``core.sweep.OBJECTIVES``):
``"folded"``, the default, scores SP on the entities its factorization
folds (``core.star.folded_edges``: AMI over E(SP), baseline Σ n_p), so a
multi-valued or optional property never makes a class predict savings
it cannot fold; ``"complete"`` scores Def. 4.8 on the entities complete
over S, as the JAX package does.  The two agree wherever every property
of the class is functional and complete.
"""
from __future__ import annotations

import itertools
import time
from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from ..core.efsp import build_subgraphs_dict
from ..core.gfsp import FSPResult
from ..core.star import StarSweepResult, num_edges, star_groups
from ..core.sweep import MAX_SWEEP_CANDIDATES, check_objective, pick_child
from ..core.triples import TripleStore
from ..registry import Registry
from .backends import ExecutionBackend, HostBackend, get_backend  # noqa: F401


@runtime_checkable
class Detector(Protocol):
    """Strategy protocol: find the best frequent star pattern of a class."""

    name: str

    def detect(self, store: TripleStore, class_id: int, *,
               backend: ExecutionBackend | None = None,
               props: Sequence[int] | None = None) -> FSPResult:
        ...


def _class_setup(store: TripleStore, class_id: int,
                 props: Sequence[int] | None):
    stats = store.class_stats(class_id)
    s_all = (np.asarray(list(props), np.int32)
             if props is not None else stats.properties)
    return s_all, int(s_all.shape[0]), stats.n_instances


def _result(store, class_id, best: StarSweepResult, am: int,
            iterations: int, evaluations: int, t0: float,
            ws=None) -> FSPResult:
    """The detection of ``best``; ``ws``, the workspace that scored it,
    gives the folded objective's baseline."""
    fsp = star_groups(store, class_id, best.props) if best.props else []
    folded = ws is not None and ws.objective == "folded"
    return FSPResult(
        class_id=class_id, props=best.props, edges=best.edges,
        ami=best.ami, am=am, iterations=iterations, evaluations=evaluations,
        exec_time_ms=(time.perf_counter() - t0) * 1e3, fsp=fsp,
        baseline_edges=ws.total if folded else None)


class GreedyDetector:
    """G.FSP -- Algorithm 2: greedy frequent-star-pattern detection.

    Starting from ``SP = S`` (all properties of class C), each sweep
    evaluates every one-property-removed subset ``SP' = SP - {p}`` on the
    execution backend and keeps the subset with the lowest
    ``#Edges(SP', C, G)``.  The descent stops when no subset improves on
    the current ``#Edges`` (Theorem 4.1), when ``AMI == 1`` (a single
    star pattern), or when ``|SP| < 2``.  Ties break by first candidate
    (assumption (c) of §4.3).  Under the folded objective the AMI = 1
    pick and stop hold only for a pattern that folds every entity.

    The whole descent runs against ONE ``backend.workspace``.  Evaluation
    accounting is backend-invariant: 1 for the initial subset, then
    ``len(SP)`` per executed sweep, 0 when the children would be
    sub-star (``|SP'| < 2``, no sweep runs).
    """

    name = "gfsp"

    def __init__(self, objective: str = "folded") -> None:
        self.objective = check_objective(objective)

    def detect(self, store, class_id, *, backend=None, props=None):
        backend = backend if backend is not None else HostBackend()
        t0 = time.perf_counter()
        s_all, n_s, am = _class_setup(store, class_id, props)
        iterations = evaluations = 0
        if n_s == 0 or am == 0:
            empty = StarSweepResult(props=(), ami=0, am=am,
                                    n_total_props=n_s, edges=0)
            return _result(store, class_id, empty, am, iterations,
                           evaluations, t0)
        ws = backend.workspace(store, class_id,
                               tuple(int(p) for p in s_all), n_s, am,
                               self.objective)
        current = ws.evaluate_current()
        n_e = int(ws.scored_entities(ws.active_mask())[0])
        evaluations += 1
        while True:
            iterations += 1
            k = len(current.props)
            # stop: children would be sub-star (|SP'| < 2) or one pattern
            # that folds every entity
            if k < 3 or (current.is_single_pattern and n_e == am):
                break
            edges, amis = ws.sweep()
            evaluations += k
            kept = ws.scored_entities(ws.drop_one_masks())
            best_child, j = pick_child(current, edges, amis, n_s, am, kept)
            if best_child.edges >= current.edges:
                break          # Theorem 4.1 prunes everything deeper
            ws.descend(j)
            current, n_e = best_child, int(kept[j])
        return _result(store, class_id, current, am, iterations,
                       evaluations, t0, ws)


class ExhaustiveDetector:
    """E.FSP -- Algorithm 1: exhaustive frequent-star-pattern detection.

    Breadth-first scans ALL property subsets of cardinality ``|S| .. 2``,
    keeping the subset that minimizes the edge objective (``objective``,
    as for G.FSP).  Each lattice level is packed into one column-mask
    stack and evaluated as a single candidate batch through
    ``SweepWorkspace.sweep_candidates``.  The workspace and its scoring
    are G.FSP's, so efsp <-> gfsp parity is exact by construction.

    Passing a pre-built ``subgraphs_dict`` (property subset ->
    ``[(object_tuple, support), ...]``), or ``min_support > 1``, runs the
    legacy gSpan-counted scan instead -- the paper-literal Algorithm 1
    over a mined pattern space.
    """

    name = "efsp"

    def __init__(self, min_support: int = 1,
                 objective: str = "folded") -> None:
        # only consulted by the legacy gSpan-counted path (the mining
        # threshold); the lattice engine evaluates every subset exactly
        self.min_support = min_support
        self.objective = check_objective(objective)

    def detect(self, store, class_id, *, backend=None, props=None,
               subgraphs_dict=None):
        t0 = time.perf_counter()
        s_all, n_s, am = _class_setup(store, class_id, props)
        if subgraphs_dict is None and self.min_support > 1:
            # a mining threshold only exists in the gSpan pattern space
            subgraphs_dict, _, _ = build_subgraphs_dict(
                store, class_id, min_support=self.min_support)
        if subgraphs_dict is not None:
            return self._detect_from_patterns(store, class_id, s_all, n_s,
                                              am, subgraphs_dict, t0)
        backend = backend if backend is not None else HostBackend()
        best: StarSweepResult | None = None
        iterations = evaluations = 0
        ws = None
        if n_s >= 2:
            ws = backend.workspace(store, class_id,
                                   tuple(int(p) for p in s_all), n_s, am,
                                   self.objective)
        s_list = [int(p) for p in s_all]
        for subset_card in range(n_s, 1, -1):
            iterations += 1
            # stream the level in engine-sized slabs: memory stays
            # O(MAX_SWEEP_CANDIDATES x n_s) even when C(n, j) explodes,
            # and every slab is one launch sequence on the device backend
            combo_iter = itertools.combinations(range(n_s), subset_card)
            while True:
                chunk = list(itertools.islice(combo_iter,
                                              MAX_SWEEP_CANDIDATES))
                if not chunk:
                    break
                m = len(chunk)
                cols = np.fromiter(
                    itertools.chain.from_iterable(chunk), dtype=np.int64,
                    count=m * subset_card).reshape(m, subset_card)
                masks = np.zeros((m, n_s), np.int32)
                masks[np.arange(m)[:, None], cols] = 1
                edges, amis = ws.sweep_candidates(masks)
                evaluations += m
                j = int(np.argmin(edges))   # first min = paper tie-break
                if best is None or int(edges[j]) < best.edges:
                    best = StarSweepResult(
                        props=tuple(sorted(s_list[i] for i in chunk[j])),
                        ami=int(amis[j]), am=am, n_total_props=n_s,
                        edges=int(edges[j]))
        if best is None:
            best = StarSweepResult(props=(), ami=0, am=am,
                                   n_total_props=n_s, edges=0)
        return _result(store, class_id, best, am, iterations,
                       evaluations, t0, ws)

    def _detect_from_patterns(self, store, class_id, s_all, n_s, am,
                              subgraphs_dict, t0):
        """Legacy Algorithm 1 over a pre-mined gSpan pattern space."""
        best: StarSweepResult | None = None
        iterations = evaluations = 0
        s_list = [int(p) for p in s_all]
        for subset_card in range(n_s, 1, -1):
            iterations += 1
            for combo in itertools.combinations(s_list, subset_card):
                subgraphs = subgraphs_dict.get(frozenset(combo), [])
                evaluations += 1
                # countEdges(subgraphs): factorized edge count of Def. 4.8
                a = len(subgraphs)
                total = num_edges(a, am, subset_card, n_s)
                if best is None or total < best.edges:
                    best = StarSweepResult(
                        props=tuple(sorted(combo)), ami=a, am=am,
                        n_total_props=n_s, edges=total)
        if best is None:
            best = StarSweepResult(props=(), ami=0, am=am,
                                   n_total_props=n_s, edges=0)
        return _result(store, class_id, best, am, iterations,
                       evaluations, t0)


class GSpanBaseline:
    """Score only the property subsets gSpan actually mined.

    The candidate space is exactly the mined pattern space: one evaluation
    per distinct property subset appearing in ``subgraphsDict`` (>= 2
    properties), rather than E.FSP's full ``2^n`` combination scan.  Under
    the paper's complete-molecule assumption every subset of S is mined,
    so the detected SP coincides with E.FSP/G.FSP; the detector exists as
    the honest gSpan-cost baseline (enumeration time dominates).
    """

    name = "gspan"

    def __init__(self, min_support: int = 1,
                 max_edges: int | None = None) -> None:
        self.min_support = min_support
        self.max_edges = max_edges

    def detect(self, store, class_id, *, backend=None, props=None):
        t0 = time.perf_counter()
        s_all, n_s, am = _class_setup(store, class_id, props)
        allowed = {int(p) for p in s_all}
        subgraphs_dict, _, _ = build_subgraphs_dict(
            store, class_id, min_support=self.min_support,
            max_edges=self.max_edges)
        best: StarSweepResult | None = None
        evaluations = 0
        # larger subsets first, then by sorted props; ties keep the first
        for key in sorted(subgraphs_dict, key=lambda k: (-len(k),
                                                         tuple(sorted(k)))):
            if len(key) < 2 or not key.issubset(allowed):
                continue
            evaluations += 1
            a = len(subgraphs_dict[key])
            total = num_edges(a, am, len(key), n_s)
            if best is None or total < best.edges:
                best = StarSweepResult(props=tuple(sorted(key)), ami=a,
                                       am=am, n_total_props=n_s, edges=total)
        if best is None:       # nothing mined: keep the full set unscored
            if n_s:
                best = (backend or HostBackend()).evaluate(
                    store, class_id, tuple(int(p) for p in s_all), n_s, am)
                evaluations += 1
            else:
                best = StarSweepResult(props=(), ami=0, am=am,
                                       n_total_props=n_s, edges=0)
        return _result(store, class_id, best, am, 1, evaluations, t0)


DETECTORS = Registry("detector")
DETECTORS.register("gfsp", GreedyDetector)
DETECTORS.register("efsp", ExhaustiveDetector)
DETECTORS.register("gspan", GSpanBaseline)


def register_detector(name: str, cls) -> None:
    DETECTORS.register(name, cls)


def get_detector(spec, **opts) -> Detector:
    """Resolve a detector: registered name (instantiated with ``opts``) or
    an already-constructed detector instance."""
    if isinstance(spec, str):
        return DETECTORS.get(spec)(**opts)
    if isinstance(spec, Detector):
        return spec
    raise TypeError(f"not a detector: {spec!r}")
