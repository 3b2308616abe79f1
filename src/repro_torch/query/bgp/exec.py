"""BGP execution on the compact form: molecule-level joins, deferred
materialization, and filter pushdown.

The paper's query claim is that G' answers star lookups at **AMI** cost
(one molecule row speaks for all of its members).  This module extends
that claim across star boundaries: a multi-star BGP is executed as a
sequence of relation joins where factorized stars stay at *molecule
granularity* until the very end --

* a factorized star evaluates to a relation whose subject column holds
  **surrogate ids** for the absorbed population (one row per matching
  molecule, var-arm columns read straight off the molecule object
  matrix) plus concrete rows for the class's raw residue;
* FILTER constraints on in-SP variables are **pushed down** to one
  vectorized comparison over the molecule object column -- a molecule
  that fails excludes every member at once, before any member is
  emitted;
* joins between such relations run molecule-to-molecule: the concrete
  side's entity values are mapped to their surrogate
  (``FactorizedGraph.molecule_of``, one binary-search join) and matched
  against the deferred side's surrogate rows, so the intermediate
  cardinality is AMI x AMI instead of AM x AM (recorded in the stats
  and returned in the stats);
* member materialization (the instanceOf-CSR gather) happens once, on
  the final joined relation.

Deferral is *guarded*: it is only sound when every (s, p, v) pair of an
absorbed member for the star's properties derives from the class's own
molecules.  Online updates can attach extra raw pairs to members (or
absorb the same entity into another class whose SP shares a property);
``deferral_eligible`` detects both with per-predicate membership probes
and falls back to the concrete strategy -- correctness never depends on
the graph being freshly compacted.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from ...core.fgraph import FactorizedGraph
from ...core.index import csr_take, in_sorted

from ..star import (StarQuery, _arm_pairs, _arm_subject_set, _intersect,
                    _join_vars, eval_factorized, eval_raw, match_molecules)
from .algebra import BGPBindings, BGPQuery, Filter, StarPattern, is_var


@dataclasses.dataclass
class Relation:
    """Intermediate BGP relation.

    ``mixed`` maps a column index to a class id: that column may hold
    surrogate ids of the class (each such row stands for the molecule's
    whole member set) interleaved with concrete entity ids -- the id
    spaces are disjoint, so a membership probe against the class's
    surrogate vector separates them exactly.
    """

    columns: tuple[str, ...]
    rows: np.ndarray                      # (R, C) int64
    mixed: dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])


def _empty_stats() -> dict:
    return {"max_intermediate": 0, "star_rows": [], "deferred_stars": 0,
            "joins": 0, "filters_pushed": 0, "result_rows": 0}


# ---------------------------------------------------------------------------
# deferral guard
# ---------------------------------------------------------------------------

def _class_member_set(fg: FactorizedGraph, table, cache: dict | None
                      ) -> np.ndarray:
    key = ("members", table.class_id)
    if cache is not None and key in cache:
        return cache[key]
    mem, _ = fg.members_of(table.surrogates)
    mem = np.unique(mem.astype(np.int64))
    if cache is not None:
        cache[key] = mem
    return mem


def _prop_pure(fg: FactorizedGraph, table, p: int,
               cache: dict | None) -> bool:
    """True iff every (s, p, v) pair of an absorbed member of the class
    derives from the class's own molecule column: no raw pair on a
    member, no pair through another class's molecule."""
    key = ("pure", table.class_id, int(p))
    if cache is not None and key in cache:
        return cache[key]
    sl = fg.store.index.pred_slice(int(p))
    subs = sl[:, 0].astype(np.int64)
    own = in_sorted(subs, table.surrogates.astype(np.int64))
    others = subs[~own]
    ok = True
    if others.shape[0]:
        osg = fg.is_surrogate(others)
        check = others[~osg]
        if osg.any():
            mem2, _ = fg.members_of(others[osg])
            check = np.concatenate([check, mem2.astype(np.int64)])
        if check.shape[0]:
            mem = _class_member_set(fg, table, cache)
            ok = not in_sorted(check, mem).any()
    if cache is not None:
        cache[key] = ok
    return ok


def deferral_eligible(fg: FactorizedGraph, star: StarPattern,
                      filters: list[Filter] | tuple[Filter, ...] = (),
                      cache: dict | None = None) -> bool:
    """Can this star evaluate at molecule granularity?"""
    if star.class_id is None:
        return False
    table = fg.tables.get(int(star.class_id))
    if table is None or table.n_molecules == 0:
        return False
    if any(table.col_of(p) is None for p, _ in star.arms):
        return False            # off-SP arm: molecule columns can't answer
    if any(f.var == star.subject for f in filters):
        return False            # subject constrained by value: stay concrete
    if star.subject in [v for _, v in star.var_arms]:
        return False            # ?s p ?s needs entity-level equality
    return all(_prop_pure(fg, table, p, cache) for p, _ in star.arms)


# ---------------------------------------------------------------------------
# per-star evaluation
# ---------------------------------------------------------------------------

def _collapse_dup_vars(cols: tuple[str, ...], rows: np.ndarray
                       ) -> tuple[tuple[str, ...], np.ndarray]:
    """Repeated variables inside one star require equality; keep the
    first occurrence of each column."""
    seen: dict[str, int] = {}
    keep: list[int] = []
    mask = np.ones(rows.shape[0], bool)
    for i, v in enumerate(cols):
        if v in seen:
            mask &= rows[:, i] == rows[:, seen[v]]
        else:
            seen[v] = i
            keep.append(i)
    if len(keep) == len(cols):
        return cols, rows
    return tuple(cols[i] for i in keep), rows[mask][:, keep]


def _apply_filters_concrete(cols: tuple[str, ...], rows: np.ndarray,
                            filters) -> np.ndarray:
    for f in filters:
        if f.var in cols:
            rows = rows[f.apply(rows[:, cols.index(f.var)])]
    return rows


def _star_query(star: StarPattern) -> StarQuery:
    return StarQuery(
        arms=tuple((p, None if is_var(o) else int(o)) for p, o in star.arms),
        class_id=star.class_id)


def _eval_star_concrete(fg: FactorizedGraph, raw_store, star: StarPattern,
                        filters, strategy: str) -> Relation:
    q = _star_query(star)
    if strategy == "raw":
        b = eval_raw(raw_store, q)
    else:
        b = eval_factorized(fg, q)
    cols = (star.subject,) + tuple(v for _, v in star.var_arms)
    cols, rows = _collapse_dup_vars(cols, b.rows())
    rows = _apply_filters_concrete(cols, rows, filters)
    return Relation(cols, rows)


def _residual_rows(fg: FactorizedGraph, star: StarPattern, filters,
                   cols: tuple[str, ...]) -> np.ndarray:
    """Concrete rows for the class's raw population (incomplete
    molecules, post-delete decompactions, online residue) -- the
    Def. 4.11 fall-back of the deferred path."""
    cid = int(star.class_id)
    cand = fg.store.index.entities_of_class(cid)
    cand = cand[~fg.is_surrogate(cand)].astype(np.int64)
    for p, o in star.ground_arms:
        if cand.shape[0] == 0:
            break
        cand = _intersect(cand, _arm_subject_set(fg, p, o))
    full_cols = (star.subject,) + tuple(v for _, v in star.var_arms)
    if cand.shape[0] == 0:
        return np.empty((0, len(cols)), np.int64)
    b = _join_vars(cand, [p for p, _ in star.var_arms],
                   lambda p, c: _arm_pairs(fg, p, c))
    ccols, rows = _collapse_dup_vars(full_cols, b.rows())
    assert ccols == cols
    return _apply_filters_concrete(cols, rows, filters)


def _eval_star_deferred(fg: FactorizedGraph, star: StarPattern, filters,
                        stats: dict, mol_rows: np.ndarray | None = None
                        ) -> Relation:
    """Molecule-granularity evaluation: one row per matching molecule
    (subject column = surrogate id), filters pushed into the object
    columns, plus the class's concrete residue."""
    cid = int(star.class_id)
    table = fg.tables[cid]
    rows_idx = (match_molecules(table, star.ground_arms)
                if mol_rows is None else np.asarray(mol_rows))
    # -- filter pushdown: one comparison per molecule answers every
    #    member of that molecule at once
    if filters and rows_idx.shape[0]:
        mask = np.ones(rows_idx.shape[0], bool)
        for p, vname in star.var_arms:
            for f in filters:
                if f.var == vname:
                    mask &= f.apply(
                        table.objects[rows_idx, table.col_of(p)]
                        .astype(np.int64))
                    stats["filters_pushed"] += 1
        rows_idx = rows_idx[mask]
    n_var = len(star.var_arms)
    def_rows = np.empty((rows_idx.shape[0], 1 + n_var), np.int64)
    def_rows[:, 0] = table.surrogates[rows_idx]
    for k, (p, _) in enumerate(star.var_arms):
        def_rows[:, 1 + k] = table.objects[rows_idx, table.col_of(p)]
    cols = (star.subject,) + tuple(v for _, v in star.var_arms)
    cols2, def_rows = _collapse_dup_vars(cols, def_rows)
    res_rows = _residual_rows(fg, star, filters, cols2)
    stats["deferred_stars"] += 1
    return Relation(cols2, np.concatenate([def_rows, res_rows], axis=0),
                    mixed={0: cid})


def eval_star(fg: FactorizedGraph, star: StarPattern, filters,
              strategy: str, deferred: bool, stats: dict, *,
              raw_store=None, mol_rows: np.ndarray | None = None
              ) -> Relation:
    if deferred and strategy == "factorized":
        return _eval_star_deferred(fg, star, filters, stats,
                                   mol_rows=mol_rows)
    return _eval_star_concrete(fg, raw_store, star, filters, strategy)


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

def _void(keys: np.ndarray) -> np.ndarray:
    """Structured 1-D view of (R, K) int64 key rows -- lexicographically
    sortable/searchable as one scalar (the ``core.index`` idiom)."""
    arr = np.ascontiguousarray(keys, np.int64)
    dt = np.dtype([(f"f{i}", np.int64) for i in range(arr.shape[1])])
    return arr.view(dt).ravel()


def _match_pairs(akeys: np.ndarray, bkeys: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """All (ai, bi) index pairs with equal key rows (sort-merge with
    multiplicities: standard BGP join semantics).  Sorts whichever side
    is SMALLER and binary-searches the other: a molecule-deferred
    relation joining a raw one sorts AMI rows, not the entity-level
    side -- and the mixed-slot combo loop re-sorts only the small side."""
    ra, rb = akeys.shape[0], bkeys.shape[0]
    if ra == 0 or rb == 0:
        return np.empty((0,), np.int64), np.empty((0,), np.int64)
    if ra < rb:
        bi, ai = _match_pairs(bkeys, akeys)
        return ai, bi
    bv = _void(bkeys)
    order = np.argsort(bv, kind="stable")
    bs = bv[order]
    av = _void(akeys)
    lo = np.searchsorted(bs, av, side="left")
    hi = np.searchsorted(bs, av, side="right")
    counts = hi - lo
    ai = np.repeat(np.arange(ra), counts)
    bi = order[csr_take(lo, counts)]
    return ai, bi


def join(fg: FactorizedGraph, a: Relation, b: Relation,
         stats: dict) -> Relation:
    """Join two relations on their shared variables.

    A shared column that is molecule-deferred on one side joins at
    molecule level: the concrete side's entity values map to their
    surrogate in the deferred side's class (``molecule_of``), so the
    deferred side's AMI rows are probed directly -- its members are
    never enumerated.  A column deferred on *both* sides materializes
    the right side first (targeted, that column only).
    """
    shared = [v for v in a.columns if v in b.columns]
    for v in shared:
        ca, cb = a.columns.index(v), b.columns.index(v)
        if ca in a.mixed and cb in b.mixed:
            b = _materialize_col(fg, b, cb)
    stats["joins"] += 1
    if not shared:
        ai = np.repeat(np.arange(a.n_rows), b.n_rows)
        bi = np.tile(np.arange(b.n_rows), a.n_rows)
        acols: list[int] = []
        bcols: list[int] = []
    else:
        acols = [a.columns.index(v) for v in shared]
        bcols = [b.columns.index(v) for v in shared]
        # slots where one side is molecule-deferred: the concrete side
        # probes it per-molecule via entity -> surrogate mapping
        mslots = []
        for j in range(len(shared)):
            if acols[j] in a.mixed:
                mslots.append((j, "a", a.mixed[acols[j]]))
            elif bcols[j] in b.mixed:
                mslots.append((j, "b", b.mixed[bcols[j]]))
        base_ak = np.ascontiguousarray(a.rows[:, acols], np.int64)
        base_bk = np.ascontiguousarray(b.rows[:, bcols], np.int64)
        ai_parts, bi_parts = [], []
        # each combination routes every row pair through exactly one
        # variant per slot (surrogate ids and entity ids are disjoint),
        # so the union is duplicate-free
        for combo in itertools.product((0, 1), repeat=len(mslots)):
            ak, bk = base_ak, base_bk
            for (j, side, cid), bit in zip(mslots, combo):
                if not bit:
                    continue
                if side == "a":     # a deferred: lift b's entities
                    if bk is base_bk:
                        bk = bk.copy()
                    bk[:, j] = fg.molecule_of(cid, base_bk[:, j])
                else:               # b deferred: lift a's entities
                    if ak is base_ak:
                        ak = ak.copy()
                    ak[:, j] = fg.molecule_of(cid, base_ak[:, j])
            ai, bi = _match_pairs(ak, bk)
            ai_parts.append(ai)
            bi_parts.append(bi)
        ai = np.concatenate(ai_parts)
        bi = np.concatenate(bi_parts)
    b_only = [j for j, v in enumerate(b.columns) if v not in a.columns]
    cols = a.columns + tuple(b.columns[j] for j in b_only)
    rows = np.concatenate(
        [a.rows[ai], b.rows[bi][:, b_only] if b_only
         else np.empty((ai.shape[0], 0), np.int64)], axis=1)
    # a shared column that was deferred resolves to the concrete side's
    # entity value: the joined row stands for that one member
    for j, v in enumerate(shared):
        if acols[j] in a.mixed:
            rows[:, acols[j]] = b.rows[bi, bcols[j]]
    mixed = {c: cid for c, cid in a.mixed.items()
             if a.columns[c] not in shared}
    for k, j in enumerate(b_only):
        if j in b.mixed and b.columns[j] not in shared:
            mixed[len(a.columns) + k] = b.mixed[j]
    return Relation(cols, rows, mixed)


# ---------------------------------------------------------------------------
# materialization
# ---------------------------------------------------------------------------

def _materialize_col(fg: FactorizedGraph, rel: Relation, col: int
                     ) -> Relation:
    """Expand one molecule-deferred column: each surrogate-valued row
    becomes one row per member (single instanceOf-CSR gather)."""
    cid = rel.mixed[col]
    mixed = {c: k for c, k in rel.mixed.items() if c != col}
    table = fg.tables.get(cid)
    rows = rel.rows
    if table is None or rows.shape[0] == 0 or table.n_molecules == 0:
        return Relation(rel.columns, rows, mixed)
    is_sg = in_sorted(rows[:, col], table.surrogates.astype(np.int64))
    if not is_sg.any():
        return Relation(rel.columns, rows, mixed)
    sg_rows = rows[is_sg]
    ents, src = fg.members_of(sg_rows[:, col])
    expanded = sg_rows[src]
    expanded[:, col] = ents
    return Relation(rel.columns,
                    np.concatenate([rows[~is_sg], expanded], axis=0), mixed)


def materialize(fg: FactorizedGraph, rel: Relation) -> Relation:
    for col in sorted(rel.mixed):
        rel = _materialize_col(fg, rel, col)
    return rel


# ---------------------------------------------------------------------------
# top-level execution
# ---------------------------------------------------------------------------

def execute_bgp(fg: FactorizedGraph, query: BGPQuery, plan, *,
                raw_store=None, mol_rows: dict[int, np.ndarray] | None = None,
                posthoc_filters: bool = False
                ) -> tuple[BGPBindings, dict]:
    """Run a planned BGP.  ``plan`` is a ``planner.BGPPlan``; fixed
    strategies come from planning with ``strategy="raw"/"factorized"``.

    ``mol_rows`` optionally injects pre-computed molecule-match rows per
    star index (the batched device path); ``posthoc_filters=True``
    evaluates the pattern unfiltered and applies every FILTER on the
    fully materialized result -- the baseline the ``filter``
    workload compares pushdown against.
    """
    stats = _empty_stats()
    filters = () if posthoc_filters else query.filters
    applied: set[Filter] = set()
    rel: Relation | None = None
    for si in plan.order:
        sp = plan.stars[si]
        star = query.stars[si]
        sfilters = [f for f in filters if f.var in star.variables]
        r = eval_star(fg, star, sfilters, sp.strategy, sp.deferred, stats,
                      raw_store=raw_store,
                      mol_rows=None if mol_rows is None
                      else mol_rows.get(si))
        applied.update(sfilters)
        stats["star_rows"].append(r.n_rows)
        stats["max_intermediate"] = max(stats["max_intermediate"], r.n_rows)
        rel = r if rel is None else join(fg, rel, r, stats)
        stats["max_intermediate"] = max(stats["max_intermediate"],
                                        rel.n_rows)
    rel = materialize(fg, rel)
    rows, cols = rel.rows, rel.columns
    for f in filters:
        if f not in applied:
            rows = rows[f.apply(rows[:, cols.index(f.var)])]
    if posthoc_filters:
        rows = _apply_filters_concrete(cols, rows, query.filters)
    perm = [cols.index(v) for v in query.variables]
    out = BGPBindings(query.variables, rows[:, perm])
    stats["result_rows"] = out.n_rows
    return out, stats
