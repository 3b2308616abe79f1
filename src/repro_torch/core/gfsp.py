"""G.FSP result type.

The greedy descent itself (Algorithm 2) lives in
``repro_torch.api.detectors.GreedyDetector``; candidate-subset execution
is a pluggable ``repro_torch.api.backends`` backend ("host" numpy loop /
"device" batched torch sweep).  Backends charge evaluations identically
(``len(SP)`` per executed sweep, 0 when children would be sub-star), so
``FSPResult.evaluations`` is backend-invariant.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FSPResult:
    """Outcome of an FSP detection run (any detector)."""

    class_id: int
    props: tuple[int, ...]          # best SP
    edges: int                      # #Edges(SP, C, G)
    ami: int                        # number of frequent star patterns
    am: int                         # AM_G(C)
    iterations: int                 # property-set iterations (PSIterations)
    evaluations: int                # subset evaluations performed
    exec_time_ms: float
    fsp: list[tuple[np.ndarray, np.ndarray]]  # star patterns: (entities, objects)
    # the class's (e, p, o) rows over S where the detector scored the
    # entities SP folds (``folded`` objective); None for Def. 4.8, whose
    # baseline is AM * |S|
    baseline_edges: int | None = None

    @property
    def n_fsp(self) -> int:
        return len(self.fsp)
