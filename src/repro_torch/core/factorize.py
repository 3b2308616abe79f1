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

from .. import obs
from .index import csr_take
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


# the counts mark ids in a bitmap of one byte an id while the ids lie in
# [0, 6n) for n rows (``np.isin``'s own rule for its table), so the bitmap
# stays under half the triple array's bytes; sparser ids take the sorted
# set operations
_DENSE_IDS_PER_ROW = 6


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
    Observation/A4 -> -16.67% when AMI == AM (6n -> 7n edges).

    The span's ``ids`` says how the ids were counted: ``"dense"`` in a
    bitmap over the graph's ids, ``"sorted"`` by sort-based set
    operations where the ids are sparse against the rows."""
    with obs.span("count") as sp:
        spo = store.spo
        n = spo.shape[0]
        if n:
            # rows are (s, p, o)-sorted: the subjects' extremes are at
            # the ends
            lo = min(int(spo[0, 0]), int(spo[:, 2].min()))
            hi = max(int(spo[-1, 0]), int(spo[:, 2].max()))
        if n and lo >= 0 and hi < _DENSE_IDS_PER_ROW * n:
            sp.set(ids="dense")
            return _dense_nle_nodes(store, class_id, hi + 1)
        sp.set(ids="sorted")
        ents = store.entities_of_class(class_id)
        # surrogates are entities of C too after factorization (sg type
        # C); instanceOf subjects are the original entities.
        inst_subj = spo[spo[:, 1] == store.INSTANCE_OF, 0]
        subjects = np.union1d(ents, inst_subj)
        mask = np.isin(spo[:, 0], subjects)
        nle = int(mask.sum())
        touched = spo[mask]
        nodes = np.unique(np.concatenate([touched[:, 0], touched[:, 2]]))
        return nle, int(nodes.shape[0])


def _dense_nle_nodes(store: TripleStore, class_id: int,
                     n_ids: int) -> tuple[int, int]:
    """:func:`_class_nle_nodes` over one bitmap of the ids ``0..n_ids-1``.
    The class's subjects (its entities and every ``instanceOf`` subject,
    read off the index) are subjects of the graph, so their bitmap is
    already the subject half of the node set: the objects of their rows
    are marked into the same bitmap."""
    idx = store.index
    marked = np.zeros(n_ids, bool)
    marked[idx.entities_of_class(class_id)] = True
    marked[idx.pred_subjects(store.INSTANCE_OF)] = True
    spo = store.spo
    mask = marked.take(spo[:, 0])
    marked[spo[:, 2][mask]] = True
    return int(np.count_nonzero(mask)), int(np.count_nonzero(marked))


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


def _splice(spo: np.ndarray, ents: np.ndarray, ent_sg: np.ndarray,
            props_arr: np.ndarray, class_id: int, type_id: int,
            instance_of_id: int, surrogate_ids: np.ndarray,
            star_objects: np.ndarray) -> tuple[np.ndarray, int]:
    """:func:`apply_molecule_map` followed by the sort and dedup, for
    surrogates above every id of the graph: ``(G' rows, rows moved)``,
    the rows sorted-unique with no sort of the graph.

    The rows that change lie in the (s, p, o)-sorted runs of the class's
    (sorted) entities ``ents``: each loses its ``(s type C)`` and SP rows
    and gains ``(s instanceOf sg)``, whose place in the run follows every
    row of predicate at most ``instanceOf`` (``sg`` is above every
    object).  The rows kept come out in one index gather.  ``sg`` is
    above every subject too, so the molecules' rows go at the tail, one
    set per star pattern: the entities are complete and functional over
    SP, so these are the distinct ``(sg type C)`` and ``(sg p o)`` rows
    of the mapped ones."""
    n, m = spo.shape[0], ents.shape[0]
    lo = np.searchsorted(spo[:, 0], ents)
    lens = np.searchsorted(spo[:, 0], ents, side="right") - lo
    run = csr_take(lo, lens)
    p, o = spo[run, 1], spo[run, 2]
    # the moved rows, one comparison a property (an ``isin`` over the
    # runs took several times longer)
    moved = (p == type_id) & (o == class_id)
    for prop in props_arr.tolist():
        moved |= p == prop
    ent = np.repeat(np.arange(m), lens)
    below = p <= instance_of_id
    # entity e's instanceOf row goes before row q[e] of the graph, after
    # the e inserted before it: a row's place among both is its index,
    # plus e, plus one past the instanceOf row
    q = lo + np.bincount(ent[below], minlength=m)
    q += np.arange(m)
    at = run + ent + ~below
    gone = at[moved]
    # the body's slot of each inserted row, and of the row after each
    # moved one: their place less the rows moved before them
    ins_at = q - np.searchsorted(gone, q)
    skip_at = gone - np.arange(gone.shape[0])
    # so the body's source row at slot j is j, plus the moved rows whose
    # next row is at j or before, less the rows inserted before j: a
    # running sum of one a slot, less one at slot 0, plus those steps
    body = n - gone.shape[0] + m
    src = np.bincount(skip_at, minlength=body + 1)
    src += 1
    src[0] -= 1
    src[ins_at + 1] -= 1
    src = np.cumsum(src, out=src)[:body]
    src[ins_at] = 0

    # the molecules: the columns in ascending predicate id, the star
    # patterns in ascending surrogate id
    preds = np.append(props_arr, np.int32(type_id))
    objs = np.concatenate(
        [star_objects, np.full((star_objects.shape[0], 1), class_id,
                               np.int32)], axis=1)
    cols = np.argsort(preds)
    groups = np.argsort(surrogate_ids)
    k = preds.shape[0]
    out = np.empty((body + groups.shape[0] * k, 3), np.int32)
    np.take(spo, src, axis=0, out=out[:body])
    out[ins_at, 0] = ents
    out[ins_at, 1] = instance_of_id
    out[ins_at, 2] = ent_sg
    tail = out[body:].reshape(-1, k, 3)
    tail[:, :, 0] = surrogate_ids[groups, None]
    tail[:, :, 1] = preds[cols]
    tail[:, :, 2] = objs[groups][:, cols]
    return out, int(gone.shape[0])


def _factorize(store: TripleStore, class_id: int, props: Sequence[int],
               surrogate_prefix: str = "repro:sg",
               surrogate_start: int = 0) -> FactorizationResult:
    """Algorithm 3 for one (class, SP) pair; returns G' and mu_N.

    ``surrogate_start`` offsets the surrogate ordinals so a later pass
    can mint fresh names that never collide with an earlier one.
    """
    with obs.span("factorize", class_id=int(class_id)):
        return _factorize_class(store, class_id, props, surrogate_prefix,
                                surrogate_start)


def _factorize_class(store, class_id, props, surrogate_prefix,
                     surrogate_start) -> FactorizationResult:
    props_arr = np.asarray(sorted(int(p) for p in props), dtype=np.int32)
    ents, objmat = store.object_matrix(class_id, props_arr)
    nle_before, nn_before = _class_nle_nodes(store, class_id)

    # -- lines 2-7: group entities by object tuple, mint surrogates --------
    # (one bulk TermDict.ids() allocation, not a per-group id() loop)
    with obs.span("mint") as sp:
        inv, counts, rep = row_groups(objmat)
        n_groups = int(counts.shape[0])
        cname = store.dict.term(class_id)
        base = len(store.dict)
        surrogate_ids = store.dict.ids(
            [f"{surrogate_prefix}/{cname}/{surrogate_start + g}"
             for g in range(n_groups)]).astype(np.int32)
        mu = dict(zip(ents.tolist(), surrogate_ids[inv].tolist()))
        star_objects = objmat[rep]
        sp.set(groups=n_groups)

    # -- lines 8-29: rebuild the edge set, vectorized ----------------------
    # surrogates minted now lie in no row: G' is the graph with the
    # class's rows spliced; names minted before (a redetect re-minting
    # them) may, and so may rdf:type as an SP property: then the mapped
    # graph is sorted and deduped
    with obs.span("rewrite") as sp:
        if (surrogate_ids >= base).all() and store.TYPE not in props_arr:
            new_spo, moved = _splice(
                store.spo, ents, surrogate_ids[inv], props_arr, class_id,
                store.TYPE, store.INSTANCE_OF, surrogate_ids, star_objects)
            gprime = TripleStore.from_ids(store.dict, new_spo,
                                          presorted=True)
            sp.set(path="splice", moved=moved)
        else:
            new_spo = apply_molecule_map(store.spo, ents, surrogate_ids[inv],
                                         props_arr, class_id, store.TYPE,
                                         store.INSTANCE_OF)
            gprime = TripleStore.from_ids(store.dict, new_spo)  # dedups
            sp.set(path="sort")
        sp.set(rows=gprime.n_triples)

    nle_after, nn_after = _class_nle_nodes(gprime, class_id)
    return FactorizationResult(
        graph=gprime, mu_n=mu, surrogates=surrogate_ids,
        class_id=class_id, props=tuple(int(x) for x in props_arr),
        n_triples_before=store.n_triples, n_triples_after=gprime.n_triples,
        nle_before=nle_before, nle_after=nle_after,
        nn_before=nn_before, nn_after=nn_after,
        star_objects=star_objects)


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
