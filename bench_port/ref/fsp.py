"""The plain reference of a compaction: G.FSP detection (the paper's
Algorithm 2 with the Def. 4.8 objective), factorization (Algorithm 3)
and the expansion back to G, in numpy over id rows.

Written from the paper (Karim, Vidal & Auer 2020, §4) and the
semantics ``src/repro_torch/api/detectors.py`` ``GreedyDetector``,
``api/snapshot.py`` ``CompactionPlanner.plan`` and
``core/factorize.py`` state in their docstrings; it shares no code with
them.  Rows group by exact object tuples (``np.unique`` order), and each
class's surrogates take the next ids of the dictionary, one per tuple in
that order, class after class in plan order, as the program's
dictionary mints them.

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


def edges(a: int, am: int, n_sp: int, n_s: int) -> int:
    """#Edges(SP, C, G), Def. 4.8."""
    return a * (n_sp + 1) + am * (n_s - n_sp)


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


def gfsp(g: Graph, cid: int, inst_id: int, sig_bits: int = 64
         ) -> ClassResult | None:
    """Algorithm 2 on one class: from SP = S, drop the property whose
    removal gives the fewest #Edges (the first candidate with AMI = 1
    wins outright, ties go to the first), while that improves; stop at
    |SP| < 3 or AMI = 1.  None where the class has fewer than two
    properties or no instances."""
    s_all = g.class_properties(cid, (inst_id,))
    n_s, am = int(s_all.shape[0]), int(g.entities(cid).shape[0])
    if n_s < 2 or am == 0:
        return None
    _, mat = g.object_matrix(cid, s_all)
    active = list(range(n_s))
    cur_ami = ami(mat, sig_bits)
    cur_edges = edges(cur_ami, am, n_s, n_s)
    evaluations, iterations = 1, 0
    while True:
        iterations += 1
        k = len(active)
        if k < 3 or cur_ami == 1:
            break
        amis = [ami(mat[:, [c for i, c in enumerate(active) if i != j]],
                    sig_bits) for j in range(k)]
        evaluations += k
        cand = [edges(a, am, k - 1, n_s) for a in amis]
        ones = [j for j, a in enumerate(amis) if a == 1]
        j = ones[0] if ones else int(np.argmin(cand))
        if cand[j] >= cur_edges:
            break
        del active[j]
        cur_ami, cur_edges = amis[j], cand[j]
    props = tuple(sorted(int(s_all[i]) for i in active))
    return ClassResult(cid, props, cur_edges, cur_ami, evaluations,
                       iterations, cur_edges, am * n_s)


def plan(g: Graph, inst_id: int, sig_bits: int = 64,
         min_savings: int = 1) -> list[ClassResult]:
    """Every class detected, those saving at least ``min_savings`` edges
    kept, ranked by savings (ties in class order)."""
    out = []
    for cid in g.classes().tolist():
        r = gfsp(g, cid, inst_id, sig_bits)
        if r is None or len(r.props) < 2:
            continue
        if r.baseline_edges - r.predicted_edges >= min_savings:
            out.append(r)
    out.sort(key=lambda r: -(r.baseline_edges - r.predicted_edges))
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
