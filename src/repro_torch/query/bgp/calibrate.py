"""Least-squares calibration of the BGP planner's cost constants.

The planner's three cost formulas (:func:`repro_torch.query.bgp.
planner.plan_star`) are linear in six per-operation constants -- per molecule
row, per residual entity, per emitted row, per scanned triple, per
off-SP pair, per mixed-slot molecule row.  That linearity makes the
constants fittable: run workloads under pinned strategies, record the
feature totals the formulas would charge alongside the observed warm
wall time, and solve the (regularized, non-negative) least-squares
system

    observed_ms  ~=  features @ constants.

:func:`calibration_report` does exactly this over a set of workloads and
reports the fitted model next to the committed defaults; the defaults in
:class:`~repro_torch.query.bgp.planner.CostModel` are a normalized fit
(``c_mol == 1``) of the reference's, kept unchanged here: a fit is
printed, it never replaces them.

The fit is intentionally crude -- ordinary ridge solve with negative
coefficients clipped to a floor -- because the planner only consumes
the *ordering* the constants induce, not their absolute scale.
"""
from __future__ import annotations

import time
from collections.abc import Sequence

import numpy as np

from ...core.fgraph import FactorizedGraph

from .algebra import BGPQuery
from .exec import deferral_eligible
from .planner import CostModel, _star_estimates, plan_bgp

#: per-star evaluation modes a feature vector can describe
MODES = ("deferred", "factorized", "raw")


def star_features(fg: FactorizedGraph, query: BGPQuery, si: int,
                  mode: str, cache: dict | None = None,
                  mixed_partners: int = 0) -> np.ndarray:
    """The 6-vector ``f`` with ``predicted cost = model.as_array() @ f``
    for evaluating star ``si`` under ``mode`` -- the same quantities
    :func:`plan_star` charges, exposed so a fit can replay them."""
    star = query.stars[si]
    filters = [f for f in query.filters if f.var in star.variables]
    est = _star_estimates(fg, star, filters, cache)
    f = np.zeros(len(CostModel.FEATURES))
    if mode == "deferred":
        f[0] = est["ami"]
        f[1] = est["raw_pop"]
        f[2] = est["mol_rows"]
        f[5] = mixed_partners * est["mol_rows"]
    elif mode == "factorized":
        f[0] = est["ami"]
        f[1] = est["raw_pop"]
        f[2] = est["est_rows"]
        f[4] = est["off_sp_pairs"]
    elif mode == "raw":
        f[2] = est["est_rows"]
        f[3] = (est["n_sem"] + est["scan"]
                + sum(fg.store.index.pred_count(p)
                      for p, _ in star.var_arms))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return f


def query_features(fg: FactorizedGraph, query: BGPQuery, strategy: str,
                   cache: dict | None = None) -> np.ndarray:
    """Feature total for a whole query under a pinned ``strategy`` --
    per star, the mode that strategy would actually execute (pinned
    ``"factorized"`` still defers when sound, mirroring the engine).
    Deferred stars sharing a variable with a non-deferred partner get
    their mixed-partner count, so the ``mix`` column is identified by
    exactly the queries that pay the granularity crossing."""
    if strategy == "raw":
        modes = ["raw"] * len(query.stars)
    else:
        modes = []
        for star in query.stars:
            filters = [f for f in query.filters
                       if f.var in star.variables]
            modes.append("deferred"
                         if deferral_eligible(fg, star, filters,
                                              cache=cache)
                         else "factorized")
    var_sets = [set(s.variables) for s in query.stars]
    total = np.zeros(len(CostModel.FEATURES))
    for si in range(len(query.stars)):
        mixed = 0
        if modes[si] == "deferred":
            mixed = sum(1 for j in range(len(query.stars))
                        if j != si and modes[j] != "deferred"
                        and var_sets[si] & var_sets[j])
        total += star_features(fg, query, si, modes[si], cache,
                               mixed_partners=mixed)
    return total


def collect_samples(engine, workloads: dict[str, Sequence[BGPQuery]],
                    strategies: Sequence[str] = ("raw", "factorized"),
                    ) -> list[tuple[np.ndarray, float]]:
    """(feature total, observed warm ms) per (workload x pinned
    strategy) cell.  Pinned strategies only: the sample must pair a
    KNOWN evaluation mode with its latency, and ``"auto"`` would fold
    the very model being fitted into the data."""
    fg = engine.fgraph
    cache: dict = {}
    samples: list[tuple[np.ndarray, float]] = []
    for queries in workloads.values():
        for strategy in strategies:
            feats = sum((query_features(fg, q, strategy, cache)
                         for q in queries),
                        np.zeros(len(CostModel.FEATURES)))
            for q in queries:                       # warm the caches
                engine.query_bgp(q, strategy=strategy, backend="host")
            t0 = time.perf_counter()
            for q in queries:
                engine.query_bgp(q, strategy=strategy, backend="host")
            samples.append((feats, (time.perf_counter() - t0) * 1e3))
    return samples


def fit_cost_model(samples: Sequence[tuple[np.ndarray, float]],
                   prior: CostModel | None = None, l2: float = 0.5,
                   floor: float = 0.05, normalize: bool = True
                   ) -> CostModel:
    """Prior-centered ridge least squares over ``samples``.

    The observed latencies identify the constants only up to what the
    workload mix exercises -- a feature column no sampled query pays
    for (or pays for only collinearly with another) would otherwise
    collapse to an arbitrary value and wreck planning everywhere else.
    So the solve is regularized toward ``prior`` (default: the current
    :class:`CostModel` defaults), after rescaling the prior to the
    sample's millisecond units by a 1-d projection.  ``l2`` trades
    data against prior in the max-normalized feature space;
    non-positive coefficients are clipped to ``floor`` x the largest
    (a cost cannot be a credit -- genuinely small positive constants
    pass through untouched); the result is scaled so ``c_mol == 1``
    when ``normalize`` -- the planner compares costs, only ratios
    matter.
    """
    prior = prior if prior is not None else CostModel()
    A = np.stack([f for f, _ in samples])
    y = np.array([ms for _, ms in samples])
    scale = A.max(axis=0)
    scale[scale == 0] = 1.0
    An = A / scale
    # project the abstract-unit prior onto millisecond units
    c0 = prior.as_array()
    pred0 = A @ c0
    alpha = float(pred0 @ y) / (float(pred0 @ pred0) or 1.0)
    b0 = alpha * c0 * scale
    k = An.shape[1]
    b, *_ = np.linalg.lstsq(An.T @ An + l2 * np.eye(k),
                            An.T @ y + l2 * b0, rcond=None)
    c = b / scale
    c = np.where(c > 0, c, floor * np.abs(c).max())
    if normalize and c[0] > 0:
        c = c / c[0]
    return CostModel.from_array(c)


def calibration_report(engine, workloads: dict[str, Sequence[BGPQuery]],
                       ) -> dict:
    """Collect, fit, and summarize: the fitted constants beside the
    committed ones, and the fit's scale-free error."""
    samples = collect_samples(engine, workloads)
    fitted = fit_cost_model(samples)
    pred = np.stack([f for f, _ in samples]) @ fitted.as_array()
    obs = np.array([ms for _, ms in samples])
    denom = float(np.abs(obs).sum()) or 1.0
    return {
        "n_samples": len(samples),
        "fitted": {k: round(float(v), 4)
                   for k, v in zip(CostModel.FEATURES,
                                   fitted.as_array())},
        "committed": {k: round(float(v), 4)
                      for k, v in zip(CostModel.FEATURES,
                                      CostModel().as_array())},
        # scale-free fit quality: predicted cost is in abstract units,
        # so compare after matching total mass
        "rel_l1_error": round(float(
            np.abs(pred * (denom / (np.abs(pred).sum() or 1.0))
                   - obs).sum() / denom), 4),
    }
