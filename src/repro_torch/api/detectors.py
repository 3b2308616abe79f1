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
           ``SweepWorkspace.sweep_candidates``.

The gSpan-counted variants -- ``efsp`` with ``min_support > 1`` or a
``subgraphs_dict``, and the ``gspan`` baseline -- need the gSpan miner,
a later slice of the port; they raise ``NotImplementedError``.
"""
from __future__ import annotations

import itertools
import time
from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from ..core.gfsp import FSPResult
from ..core.star import StarSweepResult, star_groups
from ..core.sweep import MAX_SWEEP_CANDIDATES, pick_child
from ..core.triples import TripleStore
from ..registry import Registry
from .backends import ExecutionBackend, HostBackend, get_backend  # noqa: F401

_GSPAN_LATER = ("needs the gSpan miner (core/gspan.py, core/efsp.py), which "
                "is not ported to repro_torch yet (ROADMAP.md, queue 1)")


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
            iterations: int, evaluations: int, t0: float) -> FSPResult:
    fsp = star_groups(store, class_id, best.props) if best.props else []
    return FSPResult(
        class_id=class_id, props=best.props, edges=best.edges,
        ami=best.ami, am=am, iterations=iterations, evaluations=evaluations,
        exec_time_ms=(time.perf_counter() - t0) * 1e3, fsp=fsp)


class GreedyDetector:
    """G.FSP -- Algorithm 2: greedy frequent-star-pattern detection.

    Starting from ``SP = S`` (all properties of class C), each sweep
    evaluates every one-property-removed subset ``SP' = SP - {p}`` on the
    execution backend and keeps the subset with the lowest
    ``#Edges(SP', C, G)``.  The descent stops when no subset improves on
    the current ``#Edges`` (Theorem 4.1), when ``AMI == 1`` (a single
    star pattern), or when ``|SP| < 2``.  Ties break by first candidate
    (assumption (c) of §4.3).

    The whole descent runs against ONE ``backend.workspace``.  Evaluation
    accounting is backend-invariant: 1 for the initial subset, then
    ``len(SP)`` per executed sweep, 0 when the children would be
    sub-star (``|SP'| < 2``, no sweep runs).
    """

    name = "gfsp"

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
                               tuple(int(p) for p in s_all), n_s, am)
        current = ws.evaluate_current()
        evaluations += 1
        while True:
            iterations += 1
            k = len(current.props)
            # stop: children would be sub-star (|SP'| < 2) or one pattern
            if k < 3 or current.is_single_pattern:
                break
            edges, amis = ws.sweep()
            evaluations += k
            best_child, j = pick_child(current, edges, amis, n_s, am)
            if best_child.edges >= current.edges:
                break          # Theorem 4.1 prunes everything deeper
            ws.descend(j)
            current = best_child
        return _result(store, class_id, current, am, iterations,
                       evaluations, t0)


class ExhaustiveDetector:
    """E.FSP -- Algorithm 1: exhaustive frequent-star-pattern detection.

    Breadth-first scans ALL property subsets of cardinality ``|S| .. 2``,
    keeping the subset that minimizes the Def. 4.8 edge objective.  Each
    lattice level is packed into one column-mask stack and evaluated as a
    single candidate batch through ``SweepWorkspace.sweep_candidates``.
    The entity universe is the workspace's (entities complete over S),
    shared with G.FSP, so efsp <-> gfsp parity is exact by construction.
    """

    name = "efsp"

    def __init__(self, min_support: int = 1) -> None:
        self.min_support = min_support

    def detect(self, store, class_id, *, backend=None, props=None,
               subgraphs_dict=None):
        if subgraphs_dict is not None or self.min_support > 1:
            raise NotImplementedError(
                "efsp with min_support > 1 or a subgraphs_dict "
                + _GSPAN_LATER)
        t0 = time.perf_counter()
        s_all, n_s, am = _class_setup(store, class_id, props)
        backend = backend if backend is not None else HostBackend()
        best: StarSweepResult | None = None
        iterations = evaluations = 0
        ws = None
        if n_s >= 2:
            ws = backend.workspace(store, class_id,
                                   tuple(int(p) for p in s_all), n_s, am)
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
                       evaluations, t0)


class GSpanBaseline:
    """Placeholder for the gSpan-cost baseline detector."""

    name = "gspan"

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError("detector 'gspan' " + _GSPAN_LATER)


DETECTORS = Registry("detector")
DETECTORS.register("gfsp", GreedyDetector)
DETECTORS.register("efsp", ExhaustiveDetector)
DETECTORS.register("gspan", GSpanBaseline)


def get_detector(spec, **opts) -> Detector:
    """Resolve a detector: registered name (instantiated with ``opts``) or
    an already-constructed detector instance."""
    if isinstance(spec, str):
        return DETECTORS.get(spec)(**opts)
    if isinstance(spec, Detector):
        return spec
    raise TypeError(f"not a detector: {spec!r}")
