"""Star BGP queries and their two evaluation strategies.

A *star query* is the BGP shape the paper's compaction targets: one
subject variable constrained by a set of (property, object) arms plus an
optional class:

    ?s  type C .  ?s p1 o1 .  ?s p2 ?v2 .  ...

``StarQuery`` carries the arms as ``(property_id, object_id-or-None)``
pairs (``None`` = variable object); the answer is a :class:`Bindings`
set -- one row per (subject, variable objects...) combination.

Two provably-equivalent strategies evaluate it:

``eval_raw``        -- over a *plain* graph (the original G, or the
    ``expand()`` of a factorized one): per-arm ``searchsorted`` joins on
    the ``GraphIndex`` vertical partitions, sorted-set intersections for
    ground arms, vectorized subject joins for variable arms.  This is
    what a stock engine does, and its per-arm cost scales with the
    class's **AM** (every entity carries every edge).

``eval_factorized`` -- over a :class:`~repro_torch.core.fgraph.FactorizedGraph`
    directly, **no expansion**: ground arms inside a class's SP match
    against the (M, K) molecule table (one vectorized comparison over
    AMI rows), and each matching molecule emits all of its entities in
    one ``instanceOf``-CSR gather -- a surrogate hit answers many
    entities at once.  Arms outside the SP (and entities that stayed
    raw: incomplete molecules, post-delete decompactions, unfactorized
    classes) fall back to the residual raw triples, where every arm is
    still answered with one Def. 4.11 rewriting step: raw subjects ``\\cup``
    members of matching surrogates.  Per-arm cost scales with **AMI**,
    which is the paper's "queries get faster on G'" claim made
    executable.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from ..core.fgraph import FactorizedGraph
from ..core.index import csr_take, in_sorted
from ..core.triples import TripleStore


@dataclasses.dataclass(frozen=True)
class StarQuery:
    """One star BGP: subject variable + arms (+ optional class)."""

    arms: tuple[tuple[int, int | None], ...]
    class_id: int | None = None

    def __post_init__(self):
        object.__setattr__(
            self, "arms",
            tuple((int(p), None if o is None else int(o))
                  for p, o in self.arms))

    @property
    def ground_arms(self) -> list[tuple[int, int]]:
        return [(p, o) for p, o in self.arms if o is not None]

    @property
    def var_props(self) -> list[int]:
        return [p for p, o in self.arms if o is None]


@dataclasses.dataclass
class Bindings:
    """Answer set: subjects plus one object column per variable arm."""

    subjects: np.ndarray            # (R,)
    var_props: tuple[int, ...]      # variable arms, in query-arm order
    var_objects: np.ndarray         # (R, V)

    @property
    def n_rows(self) -> int:
        return int(self.subjects.shape[0])

    def rows(self) -> np.ndarray:
        """(R, 1 + V) int64 binding rows (subject first)."""
        subs = np.asarray(self.subjects, np.int64).reshape(-1, 1)
        vo = np.asarray(self.var_objects, np.int64)
        if vo.ndim != 2:
            vo = vo.reshape(subs.shape[0], -1 if vo.size else 0)
        return np.concatenate([subs, vo], axis=1)

    def canonical(self) -> np.ndarray:
        """Sorted-unique binding rows -- strategy-order-independent."""
        r = self.rows()
        if r.shape[0] == 0:
            return r
        return np.unique(r, axis=0)

    def same_as(self, other: "Bindings") -> bool:
        a, b = self.canonical(), other.canonical()
        return a.shape == b.shape and bool((a == b).all())


def _intersect(cand: np.ndarray | None, subs: np.ndarray) -> np.ndarray:
    if cand is None:
        return subs
    return np.intersect1d(cand, subs, assume_unique=True)


def _join_vars(subjects: np.ndarray, var_props: Sequence[int],
               pairs_of: Callable[[int, np.ndarray],
                                  tuple[np.ndarray, np.ndarray]]
               ) -> Bindings:
    """Expand candidate subjects over the variable arms.

    ``pairs_of(p, cand)`` returns the (s, v) pairs of property ``p``
    sorted by subject (``cand`` -- the sorted-unique current candidate
    set -- lets strategies skip materializing pairs that cannot join);
    each join keeps subjects that have >= 1 value and multiplies binding
    rows per value (standard BGP semantics).
    """
    cols: list[np.ndarray] = []
    subjects = np.asarray(subjects)
    unique_subjects = True     # ground/class candidates come in deduped
    for p in var_props:
        s_col, v_col = pairs_of(
            p, subjects if unique_subjects else np.unique(subjects))
        unique_subjects = False     # joins may multiply rows
        lo = np.searchsorted(s_col, subjects, side="left")
        hi = np.searchsorted(s_col, subjects, side="right")
        counts = hi - lo
        v = v_col[csr_take(lo, counts)]
        subjects = np.repeat(subjects, counts)
        cols = [np.repeat(c, counts) for c in cols]
        cols.append(v)
    vo = (np.stack(cols, axis=1) if cols
          else np.empty((subjects.shape[0], 0), np.int64))
    return Bindings(subjects=subjects,
                    var_props=tuple(int(p) for p in var_props),
                    var_objects=vo)


# ---------------------------------------------------------------------------
# raw strategy (plain graphs)
# ---------------------------------------------------------------------------

def eval_raw(store: TripleStore, q: StarQuery) -> Bindings:
    """Evaluate on a plain (non-factorized) graph via index joins.

    Ground arms are sorted-set intersections over the per-predicate
    vertical partitions; variable arms are vectorized subject joins.
    Running this on a factorized store would miss absorbed entities --
    use :func:`eval_factorized` (or expand first).
    """
    idx = store.index
    cand: np.ndarray | None = None
    if q.class_id is not None:
        cand = idx.entities_of_class(int(q.class_id))
    for p, o in q.ground_arms:
        sl = idx.pred_slice(p)
        subs = sl[sl[:, 2] == o, 0]     # (s, o)-sorted slice: s unique
        cand = _intersect(cand, subs)

    def pairs_of(p: int, cand: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
        sl = idx.pred_slice(p)
        return sl[:, 0], sl[:, 2]

    var_props = q.var_props
    if cand is None:
        if not var_props:
            raise ValueError("star query needs a class or at least one arm")
        cand = np.unique(idx.pred_slice(var_props[0])[:, 0])
    return _join_vars(cand, var_props, pairs_of)


# ---------------------------------------------------------------------------
# factorized strategy (no expansion)
# ---------------------------------------------------------------------------

def _expand_subjects(fg: FactorizedGraph, subs: np.ndarray) -> np.ndarray:
    """Def. 4.11 rewriting of a subject set: surrogates are replaced by
    their members (one CSR gather), raw subjects pass through."""
    is_sg = fg.is_surrogate(subs)
    mem, _ = fg.members_of(subs[is_sg])
    return np.union1d(subs[~is_sg], mem)


def _arm_subject_set(fg: FactorizedGraph, p: int, o: int) -> np.ndarray:
    """Sorted-unique *entities* satisfying ``(?s p o)`` on G'."""
    sl = fg.store.index.pred_slice(p)
    return _expand_subjects(fg, sl[sl[:, 2] == o, 0])


def _arm_pairs(fg: FactorizedGraph, p: int,
               cand: np.ndarray | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Semantic (s, v) pairs of property ``p``, sorted by s.

    Raw pairs pass through; surrogate pairs expand to one pair per
    member.  When ``cand`` (a sorted-unique subject set) is given, pairs
    are filtered to it *before* the dedup sort -- a var-arm join over a
    selective candidate set never pays an O(AM log AM) sort.  Pairs
    derivable both raw and through a molecule (or through two molecules
    of overlapping classes) dedup.
    """
    sl = fg.store.index.pred_slice(p)
    is_sg = fg.is_surrogate(sl[:, 0])
    raw = sl[~is_sg]
    sg_rows = sl[is_sg]
    if not is_sg.any():
        # pure raw partition: the (s, o)-sorted slice is already a
        # sorted-unique pair list -- no sort needed
        if cand is None:
            return raw[:, 0].astype(np.int64), raw[:, 2].astype(np.int64)
        keep = in_sorted(raw[:, 0].astype(np.int64),
                         np.sort(np.asarray(cand, np.int64)))
        return raw[keep, 0].astype(np.int64), raw[keep, 2].astype(np.int64)
    if cand is None:
        # full expansion: every surrogate arm row emits one pair per
        # member through the CSR
        mem, src = fg.members_of(sg_rows[:, 0])
        s = np.concatenate([raw[:, 0], mem]).astype(np.int64)
        v = np.concatenate([raw[:, 2], sg_rows[src, 2]]).astype(np.int64)
    else:
        # candidate-driven: walk cand -> its surrogates (instanceOf
        # partition is subject-sorted) -> the surrogates' (p, v) rows,
        # so cost scales with the candidate set, not with AM
        cand = np.sort(np.asarray(cand, np.int64))
        keep = in_sorted(raw[:, 0].astype(np.int64), cand)
        raw = raw[keep]
        inst = fg.store.index.pred_slice(fg.store.INSTANCE_OF)
        lo = np.searchsorted(inst[:, 0], cand, side="left")
        hi = np.searchsorted(inst[:, 0], cand, side="right")
        counts = hi - lo
        cs = np.repeat(cand, counts)
        csg = inst[csr_take(lo, counts), 2]
        # values of (csg, p): extents into the surrogate rows of slice
        sg_s = sg_rows[:, 0]
        lo2 = np.searchsorted(sg_s, csg, side="left")
        hi2 = np.searchsorted(sg_s, csg, side="right")
        c2 = hi2 - lo2
        vv = sg_rows[csr_take(lo2, c2), 2]
        if raw.shape[0] == 0 and (counts <= 1).all():
            # every candidate derives through at most one surrogate and
            # nothing is raw: pairs are already sorted-unique by
            # construction (cand ascending, one extent each)
            return np.repeat(cs, c2).astype(np.int64), vv.astype(np.int64)
        s = np.concatenate([raw[:, 0], np.repeat(cs, c2)]).astype(np.int64)
        v = np.concatenate([raw[:, 2], vv]).astype(np.int64)
    pairs = np.unique(np.stack([s, v], axis=1), axis=0)
    return pairs[:, 0], pairs[:, 1]


def _class_members(fg: FactorizedGraph, class_id: int) -> np.ndarray:
    """Semantic entities of a class on G': raw-typed entities plus the
    members of the class's molecules (type edges moved to surrogates)."""
    direct = fg.store.index.entities_of_class(int(class_id))
    direct = direct[~fg.is_surrogate(direct)]
    t = fg.tables.get(int(class_id))
    if t is None:
        return direct
    mem, _ = fg.members_of(t.surrogates)
    return np.union1d(direct, mem)


def match_molecules(table, ground_sp: Sequence[tuple[int, int]]
                    ) -> np.ndarray:
    """Molecule-table rows whose object tuple satisfies the given
    (in-SP) ground arms -- one vectorized comparison over AMI rows."""
    mask = np.ones((table.n_molecules,), bool)
    for p, o in ground_sp:
        mask &= table.objects[:, table.col_of(p)] == o
    return np.flatnonzero(mask)


def eval_factorized(fg: FactorizedGraph, q: StarQuery,
                    _mol_rows: np.ndarray | None = None) -> Bindings:
    """Evaluate directly on G' (see module docstring for the split
    between the molecule-table path and the residual-raw fall-back).

    ``_mol_rows`` lets the batched device path inject the molecule-match
    result it computed for a whole query stack in one lowering; host
    callers leave it ``None``.
    """
    table = fg.tables.get(int(q.class_id)) \
        if q.class_id is not None else None
    ground = q.ground_arms
    cand: np.ndarray | None = None
    rest_ground = ground
    if table is not None:
        sp_ground = [(p, o) for p, o in ground
                     if table.col_of(p) is not None]
        rest_ground = [(p, o) for p, o in ground
                       if table.col_of(p) is None]
        # absorbed population: match the molecule table, emit members
        rows = match_molecules(table, sp_ground) \
            if _mol_rows is None else np.asarray(_mol_rows)
        a_subs, _ = fg.members_of(table.surrogates[rows])
        # raw population of the class (incomplete molecules, post-delete
        # decompactions): every arm checked against the residual triples
        b_subs = fg.store.index.entities_of_class(int(q.class_id))
        b_subs = b_subs[~fg.is_surrogate(b_subs)]
        if b_subs.shape[0] == 0:
            # fully-absorbed class (the common case): members of distinct
            # molecules are disjoint, so no dedup sort is needed
            cand = a_subs
        else:
            for p, o in sp_ground:
                if b_subs.shape[0] == 0:
                    break
                b_subs = _intersect(b_subs, _arm_subject_set(fg, p, o))
            cand = np.union1d(a_subs, b_subs)
    elif q.class_id is not None:
        cand = _class_members(fg, q.class_id)
    for p, o in rest_ground:
        if cand is not None and cand.shape[0] == 0:
            break
        cand = _intersect(cand, _arm_subject_set(fg, p, o))
    var_props = q.var_props
    if cand is None:
        if not var_props:
            raise ValueError("star query needs a class or at least one arm")
        s0, _ = _arm_pairs(fg, var_props[0])
        cand = np.unique(s0)
    return _join_vars(cand, var_props, lambda p, c: _arm_pairs(fg, p, c))
