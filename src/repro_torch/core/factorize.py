"""Algorithm 3 -- RDF graph factorization (the RDF-F problem, Def. 4.10).

Given a class C and a property set SP (output of E.FSP / G.FSP), every group
of entities sharing one object tuple over SP is replaced by a *compact RDF
molecule* (Def. 4.9): a fresh surrogate entity ``sg`` carrying

    (sg p_i o_i)  for every p_i in SP,     (sg type C),

while each original entity ``s`` keeps one ``(s instanceOf sg)`` edge and
all of its non-SP triples.  The transformation is lossless under the
Def. 4.11 axioms (see ``axioms.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .star import row_groups
from .triples import TripleStore


@dataclasses.dataclass
class FactorizationResult:
    graph: TripleStore                 # G'
    mu_n: dict[int, int]               # entity id -> surrogate id (partial map)
    surrogates: np.ndarray             # surrogate ids, one per star pattern
    class_id: int
    props: tuple[int, ...]
    # size accounting (paper §5 metrics)
    n_triples_before: int
    n_triples_after: int
    nle_before: int                    # labeled edges of C (props + instanceOf)
    nle_after: int
    nn_before: int
    nn_after: int
    # object tuple of each star pattern, aligned with ``surrogates``
    # (rows over sorted ``props``) -- lets the molecule tables build
    # without rescanning the factorized graph
    star_objects: np.ndarray | None = None

    @property
    def pct_savings_triples(self) -> float:
        if self.n_triples_before == 0:
            return 0.0
        return 100.0 * (self.n_triples_before - self.n_triples_after) \
            / self.n_triples_before

    @property
    def pct_savings_nle(self) -> float:
        """%Savings over the class's labeled edges (paper Table 5)."""
        if self.nle_before == 0:
            return 0.0
        return 100.0 * (self.nle_before - self.nle_after) / self.nle_before

    @property
    def pct_savings_size(self) -> float:
        """Savings over graph size = nodes + edges (paper Fig. 9)."""
        before = self.nn_before + self.nle_before
        after = self.nn_after + self.nle_after
        if before == 0:
            return 0.0
        return 100.0 * (before - after) / before


def _class_nle_nodes(store: TripleStore, class_id: int) -> tuple[int, int]:
    """(NLE, NN) restricted to the class: ALL labeled edges whose subject is
    an entity (or surrogate) of C -- including ``type``, ``instanceOf`` and
    auxiliary links -- and the nodes they touch.

    Calibration note: the paper's Table 1b gives NLE(D1, Observation) =
    24,142,314 for 4,092,492 observations (~5.9 edges each: property,
    procedure, generatedBy, time, result, type) and ~2.95 edges per
    measurement (value, unit, type), i.e. type edges count toward NLE.  With
    this definition the headline numbers reproduce exactly: Measurement/A8
    savings -> 66.6% as AMI/AM -> 0 (3n -> n + 3*AMI edges) and
    Observation/A4 -> -16.67% when AMI == AM (6n -> 7n edges)."""
    ents = store.entities_of_class(class_id)
    # surrogates are entities of C too after factorization (sg type C);
    # instanceOf subjects are the original entities.
    inst_subj = store.spo[store.spo[:, 1] == store.INSTANCE_OF, 0]
    subjects = np.union1d(ents, inst_subj)
    mask = np.isin(store.spo[:, 0], subjects)
    nle = int(mask.sum())
    touched = store.spo[mask]
    nodes = np.unique(np.concatenate([touched[:, 0], touched[:, 2]]))
    return nle, int(nodes.shape[0])


def apply_molecule_map(spo: np.ndarray, mu_keys: np.ndarray,
                       mu_vals: np.ndarray, props_arr: np.ndarray,
                       class_id: int, type_id: int,
                       instance_of_id: int) -> np.ndarray:
    """Vectorized lines 8-29 of Algorithm 3: rewrite the edge set under a
    (sorted) entity -> surrogate map ``mu``.

    The ``(s type C)`` edge of a mapped entity becomes ``(s instanceOf
    sg)`` + ``(sg type C)``; SP edges move to the surrogate ``(sg p o)``;
    every other edge -- including type edges naming OTHER classes -- is
    untouched.  (The seed rewrote all type edges, which merged the type
    sets of multi-typed entities onto their shared surrogate: an entity of
    classes C and D grouped with a C-only entity leaked ``type D`` to the
    latter under axiom closure.  Only the class under factorization may
    move -- Def. 4.9's compact molecule carries ``sg type C`` alone.)
    """
    s, p, o = spo[:, 0], spo[:, 1], spo[:, 2]
    in_mu = np.isin(s, mu_keys)
    mu_of_s = np.zeros_like(s)
    idx = np.searchsorted(mu_keys, s[in_mu])
    mu_of_s[in_mu] = mu_vals[idx]

    is_ctype = (p == type_id) & (o == class_id)
    in_sp = np.isin(p, props_arr)

    keep_mask = ~in_mu | (~is_ctype & ~in_sp)     # lines 19-27: untouched
    kept = spo[keep_mask]

    # lines 11-14: (s type C) -> (s instanceOf sg) + (sg type C)
    tm = in_mu & is_ctype
    inst_edges = np.stack([s[tm],
                           np.full(tm.sum(), instance_of_id, np.int32),
                           mu_of_s[tm]], axis=1)
    sg_type_edges = np.stack([mu_of_s[tm], p[tm], o[tm]], axis=1)

    # lines 15-18: SP edges -> (sg p o)
    sm = in_mu & in_sp
    sg_prop_edges = np.stack([mu_of_s[sm], p[sm], o[sm]], axis=1)

    return np.concatenate(
        [kept, inst_edges, sg_type_edges, sg_prop_edges], axis=0)


def _factorize(store: TripleStore, class_id: int, props: Sequence[int],
               surrogate_prefix: str = "repro:sg",
               surrogate_start: int = 0) -> FactorizationResult:
    """Algorithm 3 for one (class, SP) pair; returns G' and mu_N.

    ``surrogate_start`` offsets the surrogate ordinals so a later pass
    can mint fresh names that never collide with an earlier one.
    """
    props_arr = np.asarray(sorted(int(p) for p in props), dtype=np.int32)
    ents, objmat = store.object_matrix(class_id, props_arr)
    nle_before, nn_before = _class_nle_nodes(store, class_id)

    # -- lines 2-7: group entities by object tuple, mint surrogates --------
    # (one bulk TermDict.ids() allocation, not a per-group id() loop)
    inv, counts, rep = row_groups(objmat)
    n_groups = int(counts.shape[0])
    cname = store.dict.term(class_id)
    surrogate_ids = store.dict.ids(
        [f"{surrogate_prefix}/{cname}/{surrogate_start + g}"
         for g in range(n_groups)]).astype(np.int32)
    mu = dict(zip(ents.tolist(), surrogate_ids[inv].tolist()))

    # -- lines 8-29: rebuild the edge set, vectorized ----------------------
    new_spo = apply_molecule_map(store.spo, ents, surrogate_ids[inv],
                                 props_arr, class_id, store.TYPE,
                                 store.INSTANCE_OF)
    gprime = TripleStore.from_ids(store.dict, new_spo)  # dedups (set union)

    nle_after, nn_after = _class_nle_nodes(gprime, class_id)
    return FactorizationResult(
        graph=gprime, mu_n=mu, surrogates=surrogate_ids,
        class_id=class_id, props=tuple(int(x) for x in props_arr),
        n_triples_before=store.n_triples, n_triples_after=gprime.n_triples,
        nle_before=nle_before, nle_after=nle_after,
        nn_before=nn_before, nn_after=nn_after,
        star_objects=objmat[rep] if n_groups else
        np.empty((0, props_arr.size), np.int32))


def factorize_classes(store: TripleStore,
                      plans: Sequence[tuple[int, Sequence[int]]],
                      surrogate_prefix: str = "repro:sg"
                      ) -> tuple[TripleStore, list[FactorizationResult]]:
    """Factorize several (class, SP) plans sequentially (paper §5 factorizes
    Observation and Measurement independently).  This is the transactional
    execution primitive of ``repro_torch.api.Compactor``: the input store is
    never mutated, so a failure at any step leaves the caller's graph
    untouched."""
    g = store
    results = []
    for class_id, props in plans:
        res = _factorize(g, class_id, props,
                         surrogate_prefix=surrogate_prefix)
        results.append(res)
        g = res.graph
    return g, results
