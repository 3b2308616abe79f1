"""Cost-based BGP planning: per-star strategy choice and join ordering.

The single-star query matrix already shows neither fixed strategy
dominating -- factorized wins ground-arm lookups (one vectorized
comparison over AMI molecule rows vs a full predicate-slice scan), raw
wins off-SP variable arms (the factorized fall-back pays a dedup sort
over molecule-expanded pairs).  The planner makes that trade per star
from three cheap inputs, all O(log) index probes against structures the
engine already maintains:

* **AM / AMI ratios** -- ``FactorizedGraph.am/ami`` plus the raw-typed
  residue off ``GraphIndex.entities_of_class``: how much of the class
  the molecule table speaks for, and how many rows a molecule-level
  evaluation touches;
* **arm selectivity** -- ``GraphIndex.pred_object_count / pred_count``
  (per-predicate sorted-object cache): how many candidates a ground arm
  keeps;
* **filter selectivity** -- range position of the constant in the
  predicate's sorted object column.

Join order is greedy smallest-frontier-first over *connected* stars
(shared variables), so the molecule-level join probes the deferred side
with the most selective concrete side available.  ``strategy="raw"`` /
``"factorized"`` remain as caller overrides; ``"auto"`` is the planner.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ...core.fgraph import FactorizedGraph

from .algebra import BGPQuery, Filter, StarPattern
from .exec import deferral_eligible

@dataclasses.dataclass
class CostModel:
    """Per-operation constants of the planner's cost formulas.

    The defaults are a prior-centered least-squares fit against
    observed warm latencies of the reference's bgp workloads
    (``calibrate.fit_cost_model``, ``l2=0.5``, prior =
    the original hand-tuned anchors "factorized wins in-SP ground
    lookups" / "raw wins off-SP variable arms"), normalized so
    ``c_mol == 1``.  ``c_mix`` prices the granularity crossing when a
    deferred (molecule-level) relation joins an entity-level one --
    each surviving molecule row pays a membership expansion at join
    time, which the pre-fit model did not charge for at all (the ~25%
    planner miss on filtered 3-star chains).
    """
    c_mol: float = 1.0       # per molecule row compared (vectorized ==)
    c_residual: float = 0.52  # per raw-typed entity on the residual
                              #   path (prior-pinned: the fit's graph
                              #   factorizes fully, so no data here)
    c_emit: float = 0.57     # per emitted entity binding row
    c_scan: float = 0.28     # per triple scanned in a predicate slice
    c_pair: float = 1.37     # per pair through the factorized off-SP
                             #   expansion (dedup sort of _arm_pairs)
    c_mix: float = 5.6       # per deferred molecule row crossing into
                             #   an entity-granularity join

    FEATURES = ("mol", "residual", "emit", "scan", "pair", "mix")

    def as_array(self) -> np.ndarray:
        return np.array([self.c_mol, self.c_residual, self.c_emit,
                         self.c_scan, self.c_pair, self.c_mix])

    @classmethod
    def from_array(cls, a) -> "CostModel":
        return cls(*(float(x) for x in a))


#: module-level model consulted by :func:`plan_star` /
#: :func:`plan_bgp` when the caller does not pass one explicitly;
#: mutate or replace (``planner.COST = fitted``) to recalibrate a
#: whole process.
COST = CostModel()


@dataclasses.dataclass(frozen=True)
class StarPlan:
    index: int
    strategy: str               # "raw" | "factorized"
    deferred: bool              # molecule-granularity evaluation
    est_rows: float             # entity-level cardinality estimate
    est_frontier: float         # relation rows this star contributes
    cost: float                 # chosen strategy's cost estimate


@dataclasses.dataclass(frozen=True)
class BGPPlan:
    order: tuple[int, ...]
    stars: tuple[StarPlan, ...]     # indexed by star position in the query

    @property
    def strategies(self) -> tuple[str, ...]:
        return tuple(s.strategy for s in self.stars)


def _class_stats(fg: FactorizedGraph, cid: int, cache: dict | None
                 ) -> tuple[int, int, int, int]:
    """(semantic N, AMI, AM, raw residue) of a class, cached per epoch."""
    key = ("cstats", int(cid))
    if cache is not None and key in cache:
        return cache[key]
    n_typed = int(fg.store.index.entities_of_class(int(cid)).shape[0])
    ami = fg.ami(cid)
    am = fg.am(cid) if ami else 0
    raw_pop = max(n_typed - ami, 0)
    out = (am + raw_pop, ami, am, raw_pop)
    if cache is not None:
        cache[key] = out
    return out


def _filter_selectivity(fg: FactorizedGraph, p: int, f: Filter) -> float:
    objs = fg.store.index.pred_objects_sorted(int(p))
    n = int(objs.shape[0])
    if n == 0:
        return 1.0
    lo = int(np.searchsorted(objs, f.value, side="left"))
    hi = int(np.searchsorted(objs, f.value, side="right"))
    k = {"==": hi - lo, "!=": n - (hi - lo), "<": lo, "<=": hi,
         ">": n - hi, ">=": n - lo}[f.op]
    return max(k, 1) / n


def _star_estimates(fg: FactorizedGraph, star: StarPattern,
                    filters: list[Filter], cache: dict | None
                    ) -> dict:
    idx = fg.store.index
    ground_sel = 1.0
    scan_cost = 0.0
    for p, o in star.ground_arms:
        n = idx.pred_count(p)
        scan_cost += n
        ground_sel *= (idx.pred_object_count(p, o) / n) if n else 0.0
    fsel = 1.0
    var_prop = {v: p for p, v in star.var_arms}
    for f in filters:
        p = var_prop.get(f.var)
        if p is not None:
            fsel *= _filter_selectivity(fg, p, f)
    if star.class_id is not None:
        n_sem, ami, am, raw_pop = _class_stats(fg, star.class_id, cache)
    else:
        n_sem = min((idx.pred_object_count(p, o)
                     for p, o in star.ground_arms),
                    default=max((idx.pred_count(p)
                                 for p, _ in star.var_arms), default=0))
        ami = am = 0
        raw_pop = n_sem
    table = fg.tables.get(int(star.class_id)) \
        if star.class_id is not None else None
    off_sp_pairs = 0.0
    for p, _ in star.var_arms:
        if table is None or table.col_of(p) is None:
            off_sp_pairs += idx.pred_count(p)
    return {
        "n_sem": n_sem, "ami": ami, "am": am, "raw_pop": raw_pop,
        "ground_sel": ground_sel, "fsel": fsel, "scan": scan_cost,
        "off_sp_pairs": off_sp_pairs,
        "est_rows": max(n_sem * ground_sel * fsel, 1.0),
        "mol_rows": max(ami * ground_sel * fsel, 0.0),
    }


def plan_star(fg: FactorizedGraph, query: BGPQuery, si: int,
              strategy: str = "auto", cache: dict | None = None,
              cost_model: CostModel | None = None,
              mixed_partners: int = 0) -> StarPlan:
    """Cost one star.  ``mixed_partners`` is the number of already-
    planned non-deferred stars this star shares a variable with; each
    charges ``c_mix`` per surviving molecule row on the deferred
    option (the granularity-crossing expansion the join must pay)."""
    cm = cost_model if cost_model is not None else COST
    star = query.stars[si]
    filters = [f for f in query.filters if f.var in star.variables]
    est = _star_estimates(fg, star, filters, cache)
    eligible = deferral_eligible(fg, star, filters, cache=cache)

    cost_deferred = (cm.c_mol * est["ami"]
                     + cm.c_residual * est["raw_pop"]
                     + cm.c_emit * est["mol_rows"]
                     + cm.c_mix * mixed_partners * est["mol_rows"]
                     ) if eligible else np.inf
    cost_fact = (cm.c_mol * est["ami"] + cm.c_residual * est["raw_pop"]
                 + cm.c_emit * est["est_rows"]
                 + cm.c_pair * est["off_sp_pairs"])
    cost_raw = cm.c_scan * (est["n_sem"] + est["scan"]
                            + sum(fg.store.index.pred_count(p)
                                  for p, _ in star.var_arms)) \
        + cm.c_emit * est["est_rows"]

    if strategy == "raw":
        choice, deferred, cost = "raw", False, cost_raw
    elif strategy == "factorized":
        deferred = eligible
        choice = "factorized"
        cost = cost_deferred if eligible else cost_fact
    else:
        options = [(cost_deferred, "factorized", True),
                   (cost_fact, "factorized", False),
                   (cost_raw, "raw", False)]
        cost, choice, deferred = min(options, key=lambda t: t[0])
    frontier = (est["mol_rows"] + est["raw_pop"] * est["ground_sel"]
                if deferred else est["est_rows"])
    return StarPlan(index=si, strategy=choice, deferred=deferred,
                    est_rows=est["est_rows"],
                    est_frontier=max(frontier, 1.0), cost=float(cost))


def _join_order(query: BGPQuery, plans: list[StarPlan]) -> tuple[int, ...]:
    """Greedy smallest-frontier-first, preferring stars connected (by a
    shared variable) to the set already joined; disconnected components
    enter by frontier size (cross product deferred to the end)."""
    remaining = set(range(len(plans)))
    var_sets = [set(s.variables) for s in query.stars]
    order: list[int] = []
    bound: set[str] = set()
    while remaining:
        connected = [i for i in remaining if var_sets[i] & bound]
        pool = connected if connected else list(remaining)
        nxt = min(pool, key=lambda i: (plans[i].est_frontier, i))
        order.append(nxt)
        bound |= var_sets[nxt]
        remaining.discard(nxt)
    return tuple(order)


def plan_bgp(fg: FactorizedGraph, query: BGPQuery, *,
             strategy: str = "auto", cache: dict | None = None,
             cost_model: CostModel | None = None) -> BGPPlan:
    """Plan a BGP.  ``strategy`` is the caller override: ``"auto"`` runs
    the cost model per star, ``"raw"``/``"factorized"`` pin every star
    (deferral still applies under ``"factorized"`` when sound).

    Under ``"auto"`` a second pass re-prices deferred stars that share
    a variable with a non-deferred partner: the first pass costs each
    star in isolation, but a molecule-granularity relation joined
    against an entity-granularity one pays a membership expansion per
    molecule row (``CostModel.c_mix``).  Re-pricing may flip such stars
    to entity granularity; each flip can expose new mixed edges, so the
    pass iterates to a fixpoint (deferrals only ever decrease, so at
    most ``len(stars)`` rounds)."""
    if strategy not in ("auto", "raw", "factorized"):
        raise ValueError(f"unknown BGP strategy {strategy!r}")
    cm = cost_model if cost_model is not None else COST
    plans = [plan_star(fg, query, i, strategy=strategy, cache=cache,
                       cost_model=cm)
             for i in range(len(query.stars))]
    if strategy == "auto" and len(plans) > 1:
        var_sets = [set(s.variables) for s in query.stars]
        for _ in range(len(plans)):
            flipped = False
            for i, sp in enumerate(plans):
                if not sp.deferred:
                    continue
                mixed = sum(1 for j, other in enumerate(plans)
                            if j != i and not other.deferred
                            and var_sets[i] & var_sets[j])
                if not mixed:
                    continue
                repl = plan_star(fg, query, i, strategy="auto",
                                 cache=cache, cost_model=cm,
                                 mixed_partners=mixed)
                flipped |= repl.deferred != sp.deferred
                plans[i] = repl
            if not flipped:
                break
    return BGPPlan(order=_join_order(query, plans), stars=tuple(plans))
