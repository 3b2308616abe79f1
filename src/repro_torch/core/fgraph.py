"""First-class factorized RDF graph: G' as a queryable structure.

``FactorizedGraph`` holds G' as three aligned parts:

* ``store``  -- the factorized triples themselves (a ``TripleStore``:
  residual raw triples, surrogate molecule triples ``(sg p_j o_j)`` /
  ``(sg type C)``, and the ``(s instanceOf sg)`` links);
* ``tables`` -- one :class:`MoleculeTable` per factorized class: the
  surrogate column aligned with an ``(M, K)`` object matrix over the
  class's SP (Def. 4.9's compact molecules in dense form) -- this is
  what star queries match against *without expanding*;
* an ``instanceOf`` CSR -- surrogate -> member entities, rebuilt from
  the store's instanceOf partition, so one matched molecule emits all
  of its entities in a single gather.

The structure is **lossless** (Def. 4.10/4.11): :meth:`expand`
re-materializes the original graph exactly, and Def. 4.8 ``#Edges``
accounting is reproducible from the tables alone
(:meth:`def48_edges`).  Deletes and per-class decompaction are a later
slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np

from .index import SPO_PERM, csr_take, in_sorted, sort_unique
from .star import num_edges
from .triples import TripleStore


@dataclasses.dataclass
class MoleculeTable:
    """Per-class molecule table: surrogate -> (SP, object tuple) rows.

    ``surrogates`` is kept ascending with ``objects`` rows aligned; the
    object rows are ordered over the (sorted) ``props``.
    """

    class_id: int
    props: tuple[int, ...]
    surrogates: np.ndarray            # (M,) int32, ascending
    objects: np.ndarray               # (M, K) int32, rows over sorted props
    next_ordinal: int

    def __post_init__(self) -> None:
        self.props = tuple(int(p) for p in self.props)
        self.surrogates = np.asarray(self.surrogates, np.int32).reshape(-1)
        self.objects = np.asarray(self.objects, np.int32).reshape(
            self.surrogates.shape[0], len(self.props))
        order = np.argsort(self.surrogates, kind="stable")
        if not np.array_equal(order, np.arange(order.shape[0])):
            self.surrogates = self.surrogates[order]
            self.objects = self.objects[order]

    @property
    def n_molecules(self) -> int:
        return int(self.surrogates.shape[0])

    @property
    def k(self) -> int:
        return len(self.props)

    def col_of(self, prop: int) -> int | None:
        try:
            return self.props.index(int(prop))
        except ValueError:
            return None


class FactorizedGraph:
    """G' with its molecule tables and instanceOf CSR as one structure."""

    def __init__(self, store: TripleStore,
                 tables: Mapping[int, MoleculeTable]) -> None:
        self.store = store
        self.tables: dict[int, MoleculeTable] = {
            int(c): t for c, t in tables.items()}
        if self.tables:
            self.surrogate_ids = np.sort(np.concatenate(
                [t.surrogates for t in self.tables.values()])).astype(np.int32)
        else:
            self.surrogate_ids = np.empty((0,), np.int32)
        self._build_membership()

    # -- membership CSR ----------------------------------------------------
    def _build_membership(self) -> None:
        """Rebuild the surrogate -> members CSR from the instanceOf
        partition of the store (sorted by (surrogate, entity))."""
        inst = self.store.index.pred_slice(self.store.INSTANCE_OF)
        if inst.shape[0]:
            order = np.lexsort((inst[:, 0], inst[:, 2]))
            pairs = inst[order]
            self._mem_sg, first = np.unique(pairs[:, 2], return_index=True)
            self._mem_off = np.append(first, pairs.shape[0])
            self._mem = np.ascontiguousarray(pairs[:, 0])
        else:
            self._mem_sg = np.empty((0,), np.int32)
            self._mem_off = np.zeros((1,), np.int64)
            self._mem = np.empty((0,), np.int32)

    def members(self, sg: int) -> np.ndarray:
        """Sorted member entities of one surrogate (CSR slice)."""
        i = int(np.searchsorted(self._mem_sg, sg))
        if i >= self._mem_sg.shape[0] or self._mem_sg[i] != sg:
            return self._mem[:0]
        return self._mem[self._mem_off[i]:self._mem_off[i + 1]]

    def members_of(self, sgs: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Members of a surrogate *set* in one vectorized CSR gather.

        Returns ``(entities, source)``: all member entities concatenated
        plus the position into ``sgs`` each came from -- one matched
        molecule answers all of its entities at once.
        """
        sgs = np.asarray(sgs).reshape(-1)
        if self._mem_sg.shape[0] == 0 or sgs.shape[0] == 0:
            return self._mem[:0], np.empty((0,), np.int64)
        idx = np.searchsorted(self._mem_sg, sgs)
        idx_c = np.minimum(idx, max(self._mem_sg.shape[0] - 1, 0))
        present = np.zeros(sgs.shape[0], bool)
        if self._mem_sg.shape[0]:
            present = (idx < self._mem_sg.shape[0]) & \
                (self._mem_sg[idx_c] == sgs)
        starts = np.where(present, self._mem_off[idx_c], 0)
        counts = np.where(present, self._mem_off[idx_c + 1] - starts, 0)
        if int(counts.sum()) == 0:
            return self._mem[:0], np.empty((0,), np.int64)
        ents = self._mem[csr_take(starts, counts)]
        src = np.repeat(np.arange(sgs.shape[0]), counts)
        return ents, src

    def support(self, class_id: int) -> np.ndarray:
        """(M,) member count per molecule of one class."""
        t = self.tables[int(class_id)]
        _, src = self.members_of(t.surrogates)
        return np.bincount(src, minlength=t.n_molecules).astype(np.int64)

    def is_surrogate(self, ids: np.ndarray) -> np.ndarray:
        return in_sorted(np.asarray(ids).reshape(-1), self.surrogate_ids)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_compaction(cls, graph: TripleStore,
                        results: Iterable) -> "FactorizedGraph":
        """Build from ``factorize_classes`` output (the
        ``FactorizationResult`` list carries aligned surrogate /
        star-object arrays, so no rescan of G' is needed)."""
        tables: dict[int, MoleculeTable] = {}
        for res in results:
            tables[int(res.class_id)] = MoleculeTable(
                class_id=int(res.class_id),
                props=tuple(sorted(int(p) for p in res.props)),
                surrogates=res.surrogates, objects=res.star_objects,
                next_ordinal=int(res.surrogates.shape[0]))
        return cls(graph, tables)

    # -- size / accounting -------------------------------------------------
    @property
    def n_triples(self) -> int:
        return self.store.n_triples

    def residual_props(self, class_id: int) -> np.ndarray:
        """Sorted non-SP property ids carried (raw) by the class's
        absorbed entities -- the ``|S - SP|`` part of Def. 4.8."""
        t = self.tables[int(class_id)]
        ents, _ = self.members_of(t.surrogates)
        ents = np.unique(ents)
        idx = self.store.index
        sp = set(t.props)
        out = []
        for p in idx.preds.tolist():
            if p in sp or p == idx.type_id or p == idx.instance_of_id:
                continue
            subs = idx.pred_subjects(p)
            if ents.shape[0] and in_sorted(subs, ents).any():
                out.append(p)
        return np.asarray(out, np.int64)

    def def48_edges(self, class_id: int, n_s: int | None = None) -> int:
        """Def. 4.8 ``#Edges(SP, C, G)`` read off the structure:
        ``AMI * (|SP| + 1) + AM * (|S| - |SP|)`` with AMI = molecule
        count, AM = total membership, |S| measured from the residual
        raw properties unless given."""
        t = self.tables[int(class_id)]
        am = int(self.support(class_id).sum())
        if n_s is None:
            n_s = t.k + int(self.residual_props(class_id).shape[0])
        return num_edges(t.n_molecules, am, t.k, int(n_s))

    # -- losslessness ------------------------------------------------------
    def expand(self) -> TripleStore:
        """Materialize the original graph G from G' (Def. 4.10/4.11
        losslessness): every member entity takes back its molecule's
        arms and ``type`` edge; surrogate rows and ``instanceOf`` links
        disappear.  One CSR gather per class -- no per-entity loop."""
        spo = self.store.spo
        keep = (spo[:, 1] != self.store.INSTANCE_OF) & \
            ~in_sorted(spo[:, 0], self.surrogate_ids)
        parts = [spo[keep]]
        for cid, t in self.tables.items():
            ents, src = self.members_of(t.surrogates)
            if ents.shape[0] == 0:
                continue
            k = t.k
            arm_rows = np.empty((ents.shape[0] * k, 3), np.int32)
            arm_rows[:, 0] = np.repeat(ents, k)
            arm_rows[:, 1] = np.tile(np.asarray(t.props, np.int32),
                                     ents.shape[0])
            arm_rows[:, 2] = t.objects[src].ravel()
            type_rows = np.empty((ents.shape[0], 3), np.int32)
            type_rows[:, 0] = ents
            type_rows[:, 1] = self.store.TYPE
            type_rows[:, 2] = cid
            parts.extend([arm_rows, type_rows])
        return TripleStore.from_ids(self.store.dict,
                                    np.concatenate(parts, axis=0))

    def validate(self) -> None:
        """Assert the tables agree with the store's surrogate triples:
        every surrogate's rows are exactly its molecule's arms plus its
        ``type`` edge (used by tests; one vectorized pass per class)."""
        spo = self.store.spo
        for cid, t in self.tables.items():
            m, k = t.n_molecules, t.k
            want = np.empty((m * (k + 1), 3), np.int32)
            want[:, 0] = np.repeat(t.surrogates, k + 1)
            want[:, 1] = np.tile(np.append(np.asarray(t.props, np.int32),
                                           self.store.TYPE), m)
            objs = np.empty((m, k + 1), np.int32)
            objs[:, :k] = t.objects
            objs[:, k] = cid
            want[:, 2] = objs.ravel()
            got = spo[in_sorted(spo[:, 0], t.surrogates)]
            want = sort_unique(want, SPO_PERM)
            assert got.shape == want.shape and (got == want).all(), \
                (cid, got.shape, want.shape)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"FactorizedGraph(n_triples={self.n_triples}, "
                f"classes={len(self.tables)}, "
                f"molecules={int(self.surrogate_ids.shape[0])})")
