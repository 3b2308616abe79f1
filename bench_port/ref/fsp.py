"""The plain reference of a compaction: G.FSP and E.FSP detection (the
paper's Algorithms 2 and 1), factorization (Algorithm 3) and the
expansion back to G, in numpy over id rows.

Written from the paper (Karim, Vidal & Auer 2020, §4) and the
semantics ``src/repro_torch/api/detectors.py`` ``GreedyDetector`` and
``ExhaustiveDetector``, ``api/snapshot.py`` ``CompactionPlanner.plan``
and ``core/factorize.py`` state in their docstrings; it shares no code
with them.  Rows group by exact object tuples (``np.unique`` order), and
each class's surrogates take the next ids of the dictionary, one per
tuple in that order, class after class in plan order, as the program's
dictionary mints them.

The objective scores a candidate SP on the entities its factorization
folds: E(SP), the class's entities with exactly one object for every
property of SP (the rows ``Graph.object_matrix`` gives and
``factorize`` folds).  AMI is the number of distinct object tuples over
E(SP), 0 where E(SP) is empty; with n_p the class's (e, p, o) rows,

    #Edges(SP) = AMI * (|SP| + 1) + sum_{p in S} n_p - |E(SP)| * |SP|,

and the baseline is sum_{p in S} n_p, so the predicted savings,
|E(SP)| * |SP| - AMI * (|SP| + 1), are the rows the class's
factorization removes.  On a class whose properties are all functional
and complete (n_p = AM, E(SP) every entity) this is Def. 4.8 term for
term.  A multi-valued or optional property no longer makes a class
predict savings it cannot fold.

``sig_bits=16`` is the compaction cell's control: molecules grouped by
a 16-bit row hash instead of the tuple itself, a signature too narrow
for the class.  Distinct tuples that share a hash merge, so AMI drops,
the plan changes and the merged entities expand to another molecule's
objects: the compaction is lossy.  (A 32-bit hash, a one-lane
signature, merged nothing that the plan or the expansion shows at this
configuration's size in three seeds on the chip.)
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from .graph import Graph, sort_unique


def _hash(mat: np.ndarray, bits: int) -> np.ndarray:
    """A ``bits``-bit hash per row (a multiply-xorshift chain, finished
    with murmur3's fmix32, then the top bits)."""
    h = np.full(mat.shape[0], 0x9747B28C, np.uint64)
    m = np.uint64(0xFFFFFFFF)
    for j in range(mat.shape[1]):
        k = (mat[:, j].astype(np.uint64) * np.uint64(0xCC9E2D51)) & m
        h = ((h ^ k) * np.uint64(0x1B873593) + np.uint64(0xE6546B64)) & m
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & m
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & m
    h ^= h >> np.uint64(16)
    return h >> np.uint64(32 - bits)


def groups(mat: np.ndarray, sig_bits: int = 64
           ) -> tuple[np.ndarray, np.ndarray]:
    """(group of each row, one representative row index per group).
    Exact groups are the distinct rows in lexicographic order."""
    n = mat.shape[0]
    if n == 0:
        z = np.empty((0,), np.int64)
        return z, z
    if sig_bits < 64:
        _, rep, inv = np.unique(_hash(mat, sig_bits), return_index=True,
                                return_inverse=True)
        return inv.reshape(-1), rep
    order = np.lexsort(mat.T[::-1]) if mat.shape[1] else np.arange(n)
    s = mat[order]
    new = np.ones(n, bool)
    new[1:] = (s[1:] != s[:-1]).any(axis=1)
    gid = np.cumsum(new) - 1
    inv = np.empty(n, np.int64)
    inv[order] = gid
    return inv, order[new]


def ami(mat: np.ndarray, sig_bits: int = 64) -> int:
    """Multiplicity of star patterns (Def. 4.7): the distinct rows."""
    if mat.shape[0] == 0:
        return 0
    return int(groups(mat, sig_bits)[1].shape[0])


def edges(a: int, n_e: int, n_sp: int, total: int) -> int:
    """#Edges(SP, C, G) scored on the entities the factorization folds:
    ``a`` molecules of ``n_sp`` arms and a type edge each, plus the
    class's ``total`` (e, p, o) rows over S less the ``n_e * n_sp`` arms
    of the ``n_e`` folded entities.  With every property functional and
    complete (``total = AM * |S|``, ``n_e = AM``) this is Def. 4.8."""
    return a * (n_sp + 1) + total - n_e * n_sp


@dataclasses.dataclass
class ClassResult:
    class_id: int
    props: tuple[int, ...]
    edges: int
    ami: int
    evaluations: int
    iterations: int
    predicted_edges: int
    baseline_edges: int


MAX_EFSP_PROPS = 16


class ClassView:
    """One class over its properties S: each entity's count of objects
    for every property and its first object (``Graph.object_counts``),
    read once; every candidate SP is scored from them."""

    def __init__(self, g: Graph, cid: int, props: np.ndarray) -> None:
        self.props = [int(p) for p in props]
        _, self.count, self.obj = g.object_counts(cid, self.props)
        self.am = int(self.count.shape[0])
        self.total = int(self.count.sum())   # the baseline: n_p over S

    def score(self, cols, sig_bits: int = 64) -> tuple[int, int, int]:
        """(#Edges, AMI, |E|) of the columns ``cols`` of S, where E are the
        entities with exactly one object for each of them."""
        cols = list(cols)
        ok = (self.count[:, cols] == 1).all(axis=1)
        n_e = int(ok.sum())
        a = ami(self.obj[ok][:, cols], sig_bits)
        return edges(a, n_e, len(cols), self.total), a, n_e


def _view(g: Graph, cid: int, inst_id: int) -> ClassView | None:
    """The class's view over S, or None where it has fewer than two
    properties or no instances (nothing star-shaped to share)."""
    s_all = g.class_properties(cid, (inst_id,))
    if s_all.shape[0] < 2 or g.entities(cid).shape[0] == 0:
        return None
    return ClassView(g, cid, s_all)


def _result(v: ClassView, cid, cols, score, evaluations, iterations):
    e, a, _ = score
    props = tuple(sorted(v.props[i] for i in cols))
    return ClassResult(cid, props, e, a, evaluations, iterations, e,
                       v.total)


def gfsp(g: Graph, cid: int, inst_id: int, sig_bits: int = 64
         ) -> ClassResult | None:
    """Algorithm 2 on one class: from SP = S, drop the property whose
    removal gives the fewest #Edges (ties go to the first), while that
    improves; stop at |SP| < 3.  A candidate with AMI = 1 that folds
    every entity of the class wins outright, and such a current SP
    stops the descent.  None where the class has fewer than two
    properties or no instances."""
    v = _view(g, cid, inst_id)
    if v is None:
        return None
    active = list(range(len(v.props)))
    cur = v.score(active, sig_bits)
    evaluations, iterations = 1, 0
    while True:
        iterations += 1
        k = len(active)
        if k < 3 or (cur[1] == 1 and cur[2] == v.am):
            break
        cands = [v.score(active[:j] + active[j + 1:], sig_bits)
                 for j in range(k)]
        evaluations += k
        ones = [j for j, (_, a, n_e) in enumerate(cands)
                if a == 1 and n_e == v.am]
        j = ones[0] if ones else int(np.argmin([c[0] for c in cands]))
        if cands[j][0] >= cur[0]:
            break
        del active[j]
        cur = cands[j]
    return _result(v, cid, active, cur, evaluations, iterations)


def efsp(g: Graph, cid: int, inst_id: int, sig_bits: int = 64
         ) -> ClassResult | None:
    """Algorithm 1 on one class: every SP of |S| down to 2 properties, in
    ``itertools.combinations`` order over S sorted; the first strict
    minimum of #Edges wins.  ``iterations`` counts the levels and
    ``evaluations`` the subsets.  None as for ``gfsp``."""
    v = _view(g, cid, inst_id)
    if v is None:
        return None
    n_s = len(v.props)
    if n_s > MAX_EFSP_PROPS:
        raise ValueError(f"class {cid} has {n_s} properties; the exhaustive "
                         f"reference scores at most {MAX_EFSP_PROPS} "
                         f"(2^{n_s} subsets)")
    best = best_cols = None
    evaluations = 0
    for k in range(n_s, 1, -1):
        for cols in itertools.combinations(range(n_s), k):
            sc = v.score(cols, sig_bits)
            evaluations += 1
            if best is None or sc[0] < best[0]:
                best, best_cols = sc, cols
    return _result(v, cid, best_cols, best, evaluations, n_s - 1)


DETECTORS = {"gfsp": gfsp, "efsp": efsp}


def plan(g: Graph, inst_id: int, sig_bits: int = 64,
         min_savings: int = 1, detector: str = "gfsp"
         ) -> list[ClassResult]:
    """Every class detected by ``detector`` (``gfsp`` or ``efsp``), those
    saving at least ``min_savings`` edges kept, ranked by savings (ties
    in class order).

    Classes factorize in that order, and one that an entity belongs to
    twice folds it once: an earlier entry moves the entity's arms of its
    SP to a surrogate, so a later class whose SP shares one of those
    properties no longer finds it.  A later entry is kept only where it
    still saves ``min_savings`` on the entities left to it, and then
    reports the figures of those entities (``ami``, ``edges`` and
    ``predicted_edges`` over them; ``baseline_edges`` and the search's
    counts as detected), so every entry's predicted savings are the rows
    its factorization removes.  Where no two classes share an entity, as
    in a graph of singly typed entities, every entry stays as detected."""
    detect = DETECTORS[detector]
    ranked = []
    for cid in g.classes().tolist():
        r = detect(g, cid, inst_id, sig_bits)
        if r is None or len(r.props) < 2:
            continue
        if r.baseline_edges - r.predicted_edges >= min_savings:
            ranked.append(r)
    ranked.sort(key=lambda r: -(r.baseline_edges - r.predicted_edges))
    out, folded = [], []        # each kept entry's folded entities and SP
    for r in ranked:
        ents, mat = g.object_matrix(r.class_id, r.props)
        gone = np.zeros(ents.shape[0], bool)
        for f_ents, f_props in folded:
            if f_props & set(r.props):
                gone |= np.isin(ents, f_ents)
        ents, mat = ents[~gone], mat[~gone]
        k, a = len(r.props), ami(mat, sig_bits)
        e = edges(a, ents.shape[0], k, r.baseline_edges)
        if r.baseline_edges - e < min_savings:
            continue
        out.append(dataclasses.replace(r, edges=e, ami=a,
                                       predicted_edges=e))
        folded.append((ents, set(r.props)))
    return out


@dataclasses.dataclass
class Table:
    props: tuple[int, ...]
    surrogates: np.ndarray      # ascending ids
    objects: np.ndarray         # rows over props, aligned


def factorize(spo: np.ndarray, entries: list[ClassResult], n_terms: int,
              type_id: int, inst_id: int, sig_bits: int = 64
              ) -> tuple[np.ndarray, dict[int, Table]]:
    """Algorithm 3 class after class: each group of a class's entities
    sharing one object tuple over SP becomes a surrogate ``sg`` with
    ``(sg p o)`` for p in SP and ``(sg type C)``; each member keeps
    ``(s instanceOf sg)`` and its other triples.  Returns the sorted
    unique G' rows and the molecule tables."""
    rows = sort_unique(spo)
    next_id = n_terms
    tables = {}
    for e in entries:
        g = Graph(rows, type_id)
        props = np.asarray(e.props, np.int64)
        ents, mat = g.object_matrix(e.class_id, props)
        inv, rep = groups(mat, sig_bits)
        sg = next_id + np.arange(rep.shape[0], dtype=np.int64)
        next_id += rep.shape[0]
        tables[e.class_id] = Table(e.props, sg, mat[rep])
        s, p, o = rows[:, 0], rows[:, 1], rows[:, 2]
        pos = np.searchsorted(ents, s).clip(0, max(ents.shape[0] - 1, 0))
        member = ents.shape[0] > 0
        in_mu = (ents[pos] == s) if member else np.zeros(s.shape, bool)
        mu = np.where(in_mu, sg[inv[pos]] if member else 0, -1)
        ctype = (p == type_id) & (o == e.class_id)
        in_sp = np.isin(p, props)
        keep = rows[~in_mu | (~ctype & ~in_sp)]
        tm, sm = in_mu & ctype, in_mu & in_sp
        inst = np.stack([s[tm], np.full(tm.sum(), inst_id), mu[tm]], 1)
        sg_type = np.stack([mu[tm], p[tm], o[tm]], 1)
        sg_arms = np.stack([mu[sm], p[sm], o[sm]], 1)
        rows = sort_unique(np.concatenate([keep, inst, sg_type, sg_arms]))
    return rows, tables


def expand(gprime: np.ndarray, type_id: int, inst_id: int) -> np.ndarray:
    """G from G' (Def. 4.10/4.11), from the rows alone: every
    ``(s instanceOf sg)`` gives ``s`` each of ``sg``'s triples, and the
    surrogates and the instanceOf links go.  Sorted unique rows."""
    rows = np.asarray(gprime, np.int64).reshape(-1, 3)
    inst = rows[rows[:, 1] == inst_id]
    sgs = np.unique(inst[:, 2])
    is_sg = np.isin(rows[:, 0], sgs)
    plain = rows[~is_sg & (rows[:, 1] != inst_id)]
    sg_rows = rows[is_sg]
    sg_rows = sg_rows[np.argsort(sg_rows[:, 0], kind="stable")]
    lo = np.searchsorted(sg_rows[:, 0], inst[:, 2], "left")
    hi = np.searchsorted(sg_rows[:, 0], inst[:, 2], "right")
    n = hi - lo
    take = np.repeat(lo, n) + (np.arange(n.sum()) -
                               np.repeat(np.cumsum(n) - n, n))
    arms = sg_rows[take].copy()
    arms[:, 0] = np.repeat(inst[:, 0], n)
    return sort_unique(np.concatenate([plain, arms]))
