"""Def. 4.11 -- the ``instanceOf`` axioms, expansion, and query rewriting.

Axiom 1:  (s instanceOf sg) & (sg type C)   =>  (s type C)
Axiom 2:  (s instanceOf sg) & (sg p o)      =>  (s p o)     [p != type]

These make factorization lossless: the original graph is contained in the
axiom closure of the factorized graph, *without* a decompression pass.  The
same axioms drive query rewriting: a star query over the original graph is
answered over G' by allowing each (p, o) condition to be satisfied either
directly or through one ``instanceOf`` hop -- no customized engine needed.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .triples import TripleStore


def expand(store: TripleStore) -> TripleStore:
    """Materialize the axiom closure of a (possibly factorized) graph.

    One pass suffices: surrogates are never themselves instances of other
    surrogates (Algorithm 3 mints fresh entities).
    """
    spo = store.spo
    inst = spo[spo[:, 1] == store.INSTANCE_OF]          # (s, instanceOf, sg)
    if not len(inst):
        return store.copy()
    # join: inst(s, sg) |x| spo(sg, p, o)
    sg_rows = spo[spo[:, 1] != store.INSTANCE_OF]
    order = np.argsort(sg_rows[:, 0], kind="stable")
    sg_rows = sg_rows[order]
    starts = np.searchsorted(sg_rows[:, 0], inst[:, 2], side="left")
    ends = np.searchsorted(sg_rows[:, 0], inst[:, 2], side="right")
    counts = ends - starts
    total = int(counts.sum())
    if total:
        # gather indices for each (s, sg) pair
        rep_s = np.repeat(inst[:, 0], counts)
        idx = np.concatenate([np.arange(a, b) for a, b in zip(starts, ends)
                              if b > a]) if total else np.empty(0, np.int64)
        joined = sg_rows[idx]
        derived = np.stack([rep_s, joined[:, 1], joined[:, 2]], axis=1)
    else:
        derived = np.empty((0, 3), np.int32)
    out = TripleStore.from_ids(store.dict,
                               np.concatenate([spo, derived], axis=0))
    return out


def semantic_triples(store: TripleStore) -> np.ndarray:
    """The graph's *entity-level* content: axiom closure restricted to
    non-surrogate structure (drop instanceOf edges and surrogate subjects).

    Two graphs are information-equivalent iff these sets match -- this is
    the losslessness criterion tested against Def. 4.10.
    """
    closed = expand(store)
    spo = closed.spo
    surr = np.unique(spo[spo[:, 1] == store.INSTANCE_OF, 2])
    keep = (spo[:, 1] != store.INSTANCE_OF) & ~np.isin(spo[:, 0], surr)
    return np.unique(spo[keep], axis=0)


def match_star(store: TripleStore, conditions: Sequence[tuple[int, int]],
               rewrite: bool = True) -> np.ndarray:
    """Entities matching a star query ``AND_k (?s p_k o_k)``.

    ``rewrite=False`` evaluates the query literally (what a stock engine
    does on the original graph).  ``rewrite=True`` applies the Def. 4.11
    rewriting: each condition may also be satisfied via
    ``(?s instanceOf ?g) AND (?g p_k o_k)`` -- correct on factorized graphs.
    """
    spo = store.spo
    inst = spo[spo[:, 1] == store.INSTANCE_OF]
    result: np.ndarray | None = None
    for (p, o) in conditions:
        rows = spo[(spo[:, 1] == p) & (spo[:, 2] == o)]
        subjects = rows[:, 0]
        if rewrite and len(inst):
            # surrogates satisfying the condition -> their instances
            via = inst[np.isin(inst[:, 2], subjects), 0]
            subjects = np.union1d(subjects, via)
        else:
            subjects = np.unique(subjects)
        result = subjects if result is None else np.intersect1d(result, subjects)
        if result.size == 0:
            break
    if result is None:
        return np.empty((0,), np.int32)
    # exclude surrogate entities themselves from answers (they are storage
    # artifacts, not domain entities)
    if len(inst):
        result = np.setdiff1d(result, np.unique(inst[:, 2]))
    return result
