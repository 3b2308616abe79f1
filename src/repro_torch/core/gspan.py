"""gSpan (Yan & Han 2002) -- DFS-code frequent subgraph mining.

The paper's baseline E.FSP "resorts to the gSpan enumeration of frequent
patterns"; we implement gSpan itself rather than stubbing it, for directed,
vertex- and edge-labeled graphs (RDF molecules are such graphs).

A pattern is a DFS code: a sequence of tuples

    (i, j, l_i, l_e, d, l_j)

with DFS discovery ids ``i, j``, vertex labels ``l_i, l_j``, edge label
``l_e`` and direction bit ``d`` (1 if the RDF edge points i->j, else 0).
Codes are compared lexicographically; a pattern is generated only from its
*minimal* DFS code (canonical form), which removes isomorphic duplicates.
Growth follows the rightmost-path extension rule: backward edges from the
rightmost vertex only, forward edges from rightmost-path vertices only.

Support = number of database graphs containing at least one embedding.

This implementation favors clarity over constant factors -- it is the
*intentionally expensive* baseline whose enumeration E.FSP consumes; the
paper's headline result is that G.FSP avoids this cost by >= 3 orders of
magnitude.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

# ---------------------------------------------------------------------------
# database graphs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DBGraph:
    """A small directed labeled graph (one per RDF molecule)."""

    vlabels: list[int]
    # adjacency: adj[u] = list of (v, elabel, direction) where direction=1
    # means the underlying edge is u->v, 0 means v->u.  Both endpoints carry
    # the entry so DFS can traverse edges in either direction.
    adj: list[list[tuple[int, int, int]]]
    edges: list[tuple[int, int, int]]  # (u, v, elabel) with u->v

    @classmethod
    def from_edges(cls, vlabels: Sequence[int],
                   edges: Iterable[tuple[int, int, int]]) -> "DBGraph":
        vlabels = list(vlabels)
        adj: list[list[tuple[int, int, int]]] = [[] for _ in vlabels]
        es = []
        for u, v, le in edges:
            adj[u].append((v, le, 1))
            adj[v].append((u, le, 0))
            es.append((u, v, le))
        return cls(vlabels, adj, es)


Code = tuple[tuple[int, int, int, int, int, int], ...]


def _tuple_key(t) -> tuple:
    """gSpan DFS-code linear order on extension tuples.

    NOT plain lexicographic: backward edges precede forward edges, and among
    forward edges a deeper origin (larger i) is smaller (DFS discipline).
    For e1=(i1,j1), e2=(i2,j2) (Yan & Han, DFS lexicographic order):
      * both forward:  e1 < e2 iff j1 < j2 or (j1 == j2 and i1 > i2)
      * both backward: e1 < e2 iff i1 < i2 or (i1 == i2 and j1 < j2)
      * backward (i1,_) < forward (_,j2) iff i1 < j2  (always true for
        same-prefix extensions, where j2 = rightmost+1 > i1)
    ties broken by labels (l_i, l_e, d, l_j).
    """
    i, j, li, le, d, lj = t
    if i < j:   # forward
        return (1, j, -i, li, le, d, lj)
    return (0, i, j, li, le, d, lj)      # backward


def _code_key(code) -> tuple:
    return tuple(_tuple_key(t) for t in code)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Embedding:
    gid: int
    vmap: tuple[int, ...]          # dfs id -> graph vertex
    used: frozenset[tuple[int, int, int]]  # used (u, v, elabel) graph edges


def _edge_key(u: int, v: int, le: int, d: int) -> tuple[int, int, int]:
    return (u, v, le) if d == 1 else (v, u, le)


def _rightmost_path(code: Code) -> list[int]:
    """DFS ids on the rightmost path, rightmost vertex first."""
    if not code:
        return []
    # forward edges only
    path = []
    rightmost = max(max(t[0], t[1]) for t in code)
    cur = rightmost
    path.append(cur)
    while cur != 0:
        for t in reversed(code):
            i, j = t[0], t[1]
            if j == cur and i < j:     # forward edge discovering cur
                cur = i
                path.append(cur)
                break
        else:  # pragma: no cover - malformed code
            break
    return path


def _code_graph(code: Code) -> DBGraph:
    """Materialize the pattern graph described by a DFS code."""
    n = 1 + max(max(t[0], t[1]) for t in code)
    vlabels = [-1] * n
    edges = []
    for (i, j, li, le, d, lj) in code:
        vlabels[i] = li
        vlabels[j] = lj
        if d == 1:
            edges.append((i, j, le))
        else:
            edges.append((j, i, le))
    return DBGraph.from_edges(vlabels, edges)


def _min_code(g: DBGraph) -> Code:
    """Minimal DFS code of a (small) pattern graph, by exhaustive DFS."""
    best: list[Code | None] = [None]
    n_edges = len(g.edges)

    def extend(code: list, vmap: dict, rev: dict, used: set) -> None:
        if best[0] is not None and _code_key(code) > _code_key(best[0])[:len(code)]:
            return
        if len(code) == n_edges:
            c = tuple(code)
            if best[0] is None or _code_key(c) < _code_key(best[0]):
                best[0] = c
            return
        # candidate extensions, gSpan order: backward from rightmost vertex
        # (smallest target id first), then forward from rightmost path
        # (deepest origin first, i.e. rightmost vertex outward).
        rm_path = _rightmost_path(tuple(code)) if code else []
        cands = []
        if code:
            rm = rm_path[0]
            u = vmap[rm]
            for (v, le, d) in g.adj[u]:
                k = _edge_key(u, v, le, d)
                if k in used or v not in rev:
                    continue
                j = rev[v]
                if j == rm:
                    continue
                # backward edge rm -> j (only to rightmost-path vertices)
                if j in rm_path:
                    cands.append((rm, j, g.vlabels[u], le, d, g.vlabels[v]))
            for origin in rm_path:
                u = vmap[origin]
                nxt = max(vmap.keys()) + 1
                for (v, le, d) in g.adj[u]:
                    k = _edge_key(u, v, le, d)
                    if k in used or v in rev:
                        continue
                    cands.append((origin, nxt, g.vlabels[u], le, d,
                                  g.vlabels[v], v))
        else:
            for (u, v, le) in g.edges:
                cands.append((0, 1, g.vlabels[u], le, 1, g.vlabels[v], v, u))
        if not cands:
            return
        cands.sort(key=lambda t: _tuple_key(t[:6]))
        best_tuple = cands[0][:6]
        for t in cands:
            if t[:6] != best_tuple:
                break  # only minimal extension is canonical
            if len(t) == 8:  # initial edge: t = (0,1,li,le,1,lj, v, u)
                u, v = t[7], t[6]
                code.append(t[:6])
                used.add(_edge_key(u, v, t[3], 1))
                extend(code, {0: u, 1: v}, {u: 0, v: 1}, used)
                used.discard(_edge_key(u, v, t[3], 1))
                code.pop()
            elif len(t) == 7:  # forward
                origin, nxt, li, le, d, lj, v = t
                u = vmap[origin]
                k = _edge_key(u, v, le, d)
                code.append(t[:6])
                vmap[nxt] = v
                rev[v] = nxt
                used.add(k)
                extend(code, vmap, rev, used)
                used.discard(k)
                del rev[v]
                del vmap[nxt]
                code.pop()
            else:  # backward
                i, j, li, le, d, lj = t
                u = vmap[i]
                v = vmap[j]
                k = _edge_key(u, v, le, d)
                code.append(t)
                used.add(k)
                extend(code, vmap, rev, used)
                used.discard(k)
                code.pop()

    extend([], {}, {}, set())
    assert best[0] is not None
    return best[0]


def is_min(code: Code) -> bool:
    return _min_code(_code_graph(code)) == code


# ---------------------------------------------------------------------------
# mining
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Pattern:
    code: Code
    support: int
    embeddings: list[Embedding]

    @property
    def n_edges(self) -> int:
        return len(self.code)


def mine(graphs: Sequence[DBGraph], min_support: int,
         max_edges: int | None = None) -> list[Pattern]:
    """Enumerate all frequent patterns (minimal DFS codes) in ``graphs``."""
    results: list[Pattern] = []

    # frequent initial edges
    initial: dict[tuple, list[Embedding]] = {}
    for gid, g in enumerate(graphs):
        for (u, v, le) in g.edges:
            t = (0, 1, g.vlabels[u], le, 1, g.vlabels[v])
            initial.setdefault(t, []).append(
                Embedding(gid, (u, v), frozenset([(u, v, le)])))

    def support_of(embs: list[Embedding]) -> int:
        return len({e.gid for e in embs})

    def grow(code: Code, embs: list[Embedding]) -> None:
        if not is_min(code):
            return
        results.append(Pattern(code, support_of(embs), embs))
        if max_edges is not None and len(code) >= max_edges:
            return
        rm_path = _rightmost_path(code)
        rm = rm_path[0]
        nxt = 1 + max(max(t[0], t[1]) for t in code)
        # gather candidate extensions over all embeddings
        ext: dict[tuple, list[Embedding]] = {}
        for emb in embs:
            g = graphs[emb.gid]
            # backward from rightmost vertex
            u = emb.vmap[rm]
            pos = {gv: i for i, gv in enumerate(emb.vmap)}
            for (v, le, d) in g.adj[u]:
                k = _edge_key(u, v, le, d)
                if k in emb.used:
                    continue
                j = pos.get(v)
                if j is not None and j in rm_path and j != rm:
                    t = (rm, j, g.vlabels[u], le, d, g.vlabels[v])
                    ext.setdefault(t, []).append(
                        Embedding(emb.gid, emb.vmap, emb.used | {k}))
            # forward from rightmost path
            for origin in rm_path:
                u = emb.vmap[origin]
                for (v, le, d) in g.adj[u]:
                    k = _edge_key(u, v, le, d)
                    if k in emb.used or v in pos:
                        continue
                    t = (origin, nxt, g.vlabels[u], le, d, g.vlabels[v])
                    ext.setdefault(t, []).append(
                        Embedding(emb.gid, emb.vmap + (v,), emb.used | {k}))
        for t in sorted(ext.keys(), key=_tuple_key):
            child_embs = ext[t]
            if support_of(child_embs) >= min_support:
                grow(code + (t,), child_embs)

    for t in sorted(initial.keys(), key=_tuple_key):
        embs = initial[t]
        if support_of(embs) >= min_support:
            grow((t,), embs)
    return results


# ---------------------------------------------------------------------------
# RDF molecules -> database graphs (for E.FSP)
# ---------------------------------------------------------------------------

def molecules_of_class(store, class_id: int):
    """One DBGraph per entity of C: a star of its (property, object) edges.

    Vertex 0 is the subject, labeled with the class id; object vertices are
    labeled with their object id (gSpan mines constant patterns -- paper §3.3:
    'only patterns with constants are considered').
    Returns (entities, graphs).
    """
    import numpy as np
    ents = store.entities_of_class(class_id)
    props = store.class_properties(class_id)
    sel = np.isin(store.spo[:, 0], ents) & np.isin(store.spo[:, 1], props)
    spo = store.spo[sel]
    order = np.argsort(spo[:, 0], kind="stable")
    spo = spo[order]
    graphs = []
    bounds = np.searchsorted(spo[:, 0], ents)
    bounds = np.concatenate([bounds, [spo.shape[0]]])
    for i in range(ents.shape[0]):
        rows = spo[bounds[i]:bounds[i + 1]]
        vlabels = [int(class_id)] + [int(o) for o in rows[:, 2]]
        edges = [(0, 1 + k, int(p)) for k, p in enumerate(rows[:, 1])]
        graphs.append(DBGraph.from_edges(vlabels, edges))
    return ents, graphs
