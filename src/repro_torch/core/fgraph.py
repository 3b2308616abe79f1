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
(:meth:`def48_edges`).  It also supports **deletes** -- the one
mutation factorization makes non-trivial: removing a triple covered by
a molecule makes its entity *exit* the molecule (the entity's surviving
arms re-materialize as raw triples), and any molecule whose support
drops below the payoff threshold (``k(m-1) > 1``, i.e. support >= 2)
decompacts in place.  Delete methods are pure: they return a new
``FactorizedGraph`` so ``repro_torch.api.Compactor`` can commit
transactionally.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

from .. import obs
from .index import (PSO_PERM, SPO_PERM, csr_take, in_sorted, row_keys,
                    sort_unique)
from .star import num_edges
from .triples import TripleStore


@dataclasses.dataclass
class MoleculeTable:
    """Per-class molecule table: surrogate -> (SP, object tuple) rows.

    ``surrogates`` is kept ascending with ``objects`` rows aligned; the
    object rows are ordered over the (sorted) ``props``.  ``sig`` maps
    object tuples back to surrogates -- the incremental-update index
    that used to live privately inside ``Compactor``.
    """

    class_id: int
    props: tuple[int, ...]
    surrogates: np.ndarray            # (M,) int32, ascending
    objects: np.ndarray               # (M, K) int32, rows over sorted props
    next_ordinal: int
    # construction fast path: the arrays are already ascending-by-
    # surrogate (amortized append below) -- skip the O(M log M) argsort
    presorted: dataclasses.InitVar[bool] = False

    def __post_init__(self, presorted: bool = False) -> None:
        self.props = tuple(int(p) for p in self.props)
        self.surrogates = np.asarray(self.surrogates, np.int32).reshape(-1)
        self.objects = np.asarray(self.objects, np.int32).reshape(
            self.surrogates.shape[0], len(self.props))
        if not presorted:
            order = np.argsort(self.surrogates, kind="stable")
            if not np.array_equal(order, np.arange(order.shape[0])):
                self.surrogates = self.surrogates[order]
                self.objects = self.objects[order]
        self._sig: dict[tuple[int, ...], int] | None = None
        # geometric append buffer shared along a with_rows chain:
        # (capacity surrogates, capacity objects, [rows used]) -- the
        # used cell is the copy-on-branch guard
        self._append: tuple[np.ndarray, np.ndarray, list[int]] | None = None

    @property
    def n_molecules(self) -> int:
        return int(self.surrogates.shape[0])

    @property
    def k(self) -> int:
        return len(self.props)

    @property
    def sig(self) -> dict[tuple[int, ...], int]:
        """Object tuple -> surrogate id (lazily built, cached)."""
        if self._sig is None:
            self._sig = {tuple(row): int(sg) for row, sg in
                         zip(self.objects.tolist(), self.surrogates.tolist())}
        return self._sig

    def row_of(self, sg: int) -> int:
        i = int(np.searchsorted(self.surrogates, sg))
        if i >= self.n_molecules or self.surrogates[i] != sg:
            raise KeyError(sg)
        return i

    def col_of(self, prop: int) -> int | None:
        try:
            return self.props.index(int(prop))
        except ValueError:
            return None

    def with_rows(self, new_surrogates, new_objects,
                  next_ordinal: int) -> "MoleculeTable":
        """New table with appended molecule rows (update path).

        The ingest hot path appends *freshly minted* surrogate ids --
        strictly ascending past the current tail -- so the append runs
        amortized O(rows added): rows land in a geometrically grown
        capacity buffer shared along the chain of successor tables, and
        each successor is a (presorted) view of its prefix.  Old tables
        stay valid -- their views cover only rows written before the
        append -- and branching two successors off one table falls back
        to a fresh buffer (copy-on-branch, guarded by the used counter).
        Non-ascending appends (surrogate id reuse after a redetect) take
        the plain concatenate-and-resort path.
        """
        new_s = np.asarray(new_surrogates, np.int32).reshape(-1)
        new_o = np.asarray(new_objects, np.int32).reshape(-1, self.k)
        m, n = self.n_molecules, int(new_s.shape[0])
        if n == 0:
            return MoleculeTable(
                class_id=self.class_id, props=self.props,
                surrogates=self.surrogates, objects=self.objects,
                next_ordinal=next_ordinal, presorted=True)
        ascending = bool(np.all(np.diff(new_s) > 0)) and \
            (m == 0 or int(new_s[0]) > int(self.surrogates[-1]))
        if not ascending:
            return MoleculeTable(
                class_id=self.class_id, props=self.props,
                surrogates=np.concatenate([self.surrogates, new_s]),
                objects=np.concatenate([self.objects, new_o]),
                next_ordinal=next_ordinal)
        buf = self._append
        if buf is None or buf[2][0] != m or buf[0].shape[0] < m + n:
            cap = max(2 * (m + n), 16)
            buf_s = np.empty((cap,), np.int32)
            buf_o = np.empty((cap, max(self.k, 1)), np.int32)
            buf_s[:m] = self.surrogates
            if self.k:
                buf_o[:m, :self.k] = self.objects
            buf = (buf_s, buf_o, [m])
        buf[0][m:m + n] = new_s
        if self.k:
            buf[1][m:m + n, :self.k] = new_o
        buf[2][0] = m + n
        out = MoleculeTable(
            class_id=self.class_id, props=self.props,
            surrogates=buf[0][:m + n], objects=buf[1][:m + n, :self.k],
            next_ordinal=next_ordinal, presorted=True)
        out._append = buf
        self._append = None     # successor owns the buffer now
        if self._sig is not None:
            # sig ownership transfer: extending the parent's map costs
            # O(n), rebuilding it on the successor would cost O(m + n)
            sig = self._sig
            self._sig = None    # parent rebuilds lazily if probed again
            for row, sg in zip(new_o.tolist(), new_s.tolist()):
                sig[tuple(row)] = int(sg)
            out._sig = sig
        return out

    def without_rows(self, drop: Sequence[int]) -> "MoleculeTable":
        keep = np.ones((self.n_molecules,), bool)
        keep[list(drop)] = False
        return MoleculeTable(
            class_id=self.class_id, props=self.props,
            surrogates=self.surrogates[keep], objects=self.objects[keep],
            next_ordinal=self.next_ordinal)


@dataclasses.dataclass
class DeleteStats:
    """Outcome of one ``delete_triples`` / ``delete_entities`` pass."""

    n_requested: int = 0
    n_raw_removed: int = 0          # rows removed directly from the store
    n_exits: int = 0                # (entity, molecule) memberships dissolved
    n_decompacted: int = 0          # entities re-materialized as raw triples
    n_molecules_removed: int = 0    # molecules invalidated / below payoff
    # class id -> {"exits" | "decompacted" | "molecules_removed": count};
    # the drift tracker consumes these to attribute support decay to the
    # classes that suffered it (repro_torch.online.drift)
    per_class: dict = dataclasses.field(default_factory=dict)

    def note_class(self, cid: int, key: str, n: int = 1) -> None:
        if n:
            d = self.per_class.setdefault(int(cid), {})
            d[key] = d.get(key, 0) + int(n)


def _keep_mask(rows: np.ndarray, drop: np.ndarray, perm) -> np.ndarray:
    """False where a row of ``rows`` (sorted-unique under ``perm``) is
    one of ``drop``.  The few dropped keys are searched in the many rows,
    O(m log n), rather than every row in the dropped keys."""
    keep = np.ones(rows.shape[0], bool)
    if rows.shape[0] == 0:
        return keep
    keys, d = row_keys(perm, rows, sort_unique(drop, perm))
    pos = np.searchsorted(keys, d)
    hit = pos < keys.shape[0]
    hit[hit] = keys[pos[hit]] == d[hit]
    keep[pos[hit]] = False
    return keep


# the support below which a molecule stops paying for itself: a molecule
# of k >= 2 arms and m members saves k(m - 1) - 1 edges, positive iff
# m >= 2 (see Def. 4.8 / Fig. 7's overhead case)
PAYOFF_MIN_SUPPORT = 2


class FactorizedGraph:
    """G' with its molecule tables and instanceOf CSR as one structure."""

    def __init__(self, store: TripleStore,
                 tables: Mapping[int, MoleculeTable], *,
                 payoff_min_support: int = PAYOFF_MIN_SUPPORT) -> None:
        self.store = store
        self.tables: dict[int, MoleculeTable] = {
            int(c): t for c, t in tables.items()}
        self.payoff_min_support = int(payoff_min_support)
        if self.tables:
            self.surrogate_ids = np.sort(np.concatenate(
                [t.surrogates for t in self.tables.values()])).astype(np.int32)
        else:
            self.surrogate_ids = np.empty((0,), np.int32)
        # surrogate locator: sg -> (class, table row), vectorized-friendly
        loc_cid, loc_row = [], []
        for cid, t in self.tables.items():
            loc_cid.append(np.full((t.n_molecules,), cid, np.int64))
            loc_row.append(np.arange(t.n_molecules, dtype=np.int64))
        if self.tables:
            cat_sg = np.concatenate([t.surrogates
                                     for t in self.tables.values()])
            order = np.argsort(cat_sg, kind="stable")
            self._loc_sg = cat_sg[order]
            self._loc_cid = np.concatenate(loc_cid)[order]
            self._loc_row = np.concatenate(loc_row)[order]
        else:
            self._loc_sg = np.empty((0,), np.int32)
            self._loc_cid = np.empty((0,), np.int64)
            self._loc_row = np.empty((0,), np.int64)
        # contiguous subject columns for per-entity binary searches
        # (filled on first use by surrogates_of / _subject_rows)
        self._inst_subjects: np.ndarray | None = None
        self._spo_subjects: np.ndarray | None = None
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

    def am(self, class_id: int) -> int:
        """Total absorbed membership of a class (Def. 4.8's AM over the
        factorized population) -- a planner cardinality input."""
        t = self.tables.get(int(class_id))
        if t is None or t.n_molecules == 0:
            return 0
        return int(self.support(int(class_id)).sum())

    def ami(self, class_id: int) -> int:
        """Molecule count of a class (Def. 4.8's AMI): the row count a
        molecule-granularity evaluation touches."""
        t = self.tables.get(int(class_id))
        return int(t.n_molecules) if t is not None else 0

    def molecule_of(self, class_id: int, ents: np.ndarray) -> np.ndarray:
        """Per entity, the surrogate it is absorbed under in this class
        (-1 if not absorbed there).  One binary-search walk over the
        subject column of the instanceOf partition -- the entity ->
        molecule side of a molecule-level join, O(n log) in the probe
        set, never in AM."""
        ents = np.asarray(ents, np.int64).reshape(-1)
        out = np.full(ents.shape[0], -1, np.int64)
        t = self.tables.get(int(class_id))
        if t is None or t.n_molecules == 0 or ents.shape[0] == 0:
            return out
        sl = self.store.index.pred_slice(self.store.INSTANCE_OF)
        if sl.shape[0] == 0:
            return out
        if self._inst_subjects is None:
            self._inst_subjects = np.ascontiguousarray(sl[:, 0])
        lo = np.searchsorted(self._inst_subjects, ents, side="left")
        hi = np.searchsorted(self._inst_subjects, ents, side="right")
        counts = hi - lo
        src = np.repeat(np.arange(ents.shape[0]), counts)
        sgs = sl[csr_take(lo, counts), 2].astype(np.int64)
        keep = in_sorted(sgs, t.surrogates.astype(np.int64))
        out[src[keep]] = sgs[keep]
        return out

    def is_surrogate(self, ids: np.ndarray) -> np.ndarray:
        return in_sorted(np.asarray(ids).reshape(-1), self.surrogate_ids)

    def surrogates_of(self, entity: int) -> np.ndarray:
        """Surrogates the entity is an instance of (possibly several --
        one per factorized class it was absorbed into)."""
        sl = self.store.index.pred_slice(self.store.INSTANCE_OF)
        if self._inst_subjects is None:
            self._inst_subjects = np.ascontiguousarray(sl[:, 0])
        lo = int(np.searchsorted(self._inst_subjects, entity, side="left"))
        hi = int(np.searchsorted(self._inst_subjects, entity, side="right"))
        return sl[lo:hi, 2]

    def _subject_rows(self, s: int) -> np.ndarray:
        """The store's rows with subject ``s``.  The binary search runs
        on a contiguous copy of the subject column, made once per graph:
        searching the strided ``spo[:, 0]`` view would copy the whole
        column on every probe, O(|G|) per surrogate of a delete."""
        if self._spo_subjects is None:
            self._spo_subjects = np.ascontiguousarray(self.store.spo[:, 0])
        lo = np.searchsorted(self._spo_subjects, s, "left")
        hi = np.searchsorted(self._spo_subjects, s, "right")
        return self.store.spo[lo:hi]

    def locate(self, sg: int) -> tuple[int, int]:
        """(class_id, table row) of a surrogate."""
        i = int(np.searchsorted(self._loc_sg, sg))
        if i >= self._loc_sg.shape[0] or self._loc_sg[i] != sg:
            raise KeyError(sg)
        return int(self._loc_cid[i]), int(self._loc_row[i])

    # -- construction ------------------------------------------------------
    @classmethod
    def from_compaction(cls, graph: TripleStore, results: Iterable,
                        **kw) -> "FactorizedGraph":
        """Build from ``factorize_classes`` output (the
        ``FactorizationResult`` list carries aligned surrogate /
        star-object arrays, so no rescan of G' is needed)."""
        with obs.span("fgraph.build") as sp:
            tables: dict[int, MoleculeTable] = {}
            for res in results:
                tables[int(res.class_id)] = MoleculeTable(
                    class_id=int(res.class_id),
                    props=tuple(sorted(int(p) for p in res.props)),
                    surrogates=res.surrogates, objects=res.star_objects,
                    next_ordinal=int(res.surrogates.shape[0]))
            sp.set(molecules=sum(t.n_molecules for t in tables.values()))
            return cls(graph, tables, **kw)

    def with_store(self, store: TripleStore) -> "FactorizedGraph":
        """Re-host the same tables on a semantically identical store
        (tier migration: the background recompression packs the store
        and swaps it under the unchanged molecule tables)."""
        return FactorizedGraph(store, dict(self.tables),
                               payoff_min_support=self.payoff_min_support)

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

    def decompact_classes(self, class_ids: Iterable[int]
                          ) -> "FactorizedGraph":
        """Decompact ONLY the given classes: their members take their
        molecule arms and ``type`` edges back as raw triples, their
        surrogate rows and ``instanceOf`` links disappear, and every
        other class's table and triples pass through untouched.  This is
        the targeted-redetection primitive (``CompactionPlanner.
        redetect``): the rebuilt store costs one sort over the result,
        proportional to the dirty classes' footprint plus one pass over
        the store -- never a re-factorization of the clean classes."""
        cids = sorted({int(c) for c in class_ids if int(c) in self.tables})
        if not cids:
            return self
        drop_sgs = np.sort(np.concatenate(
            [self.tables[c].surrogates for c in cids]).astype(np.int64))
        spo = self.store.spo
        keep = ~in_sorted(spo[:, 0].astype(np.int64), drop_sgs) & \
            ~((spo[:, 1] == self.store.INSTANCE_OF) &
              in_sorted(spo[:, 2].astype(np.int64), drop_sgs))
        parts = [spo[keep]]
        for cid in cids:
            t = self.tables[cid]
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
        store = TripleStore.from_ids(self.store.dict,
                                     np.concatenate(parts, axis=0))
        tables = {c: t for c, t in self.tables.items() if c not in cids}
        return FactorizedGraph(store, tables,
                               payoff_min_support=self.payoff_min_support)

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

    # -- deletes -----------------------------------------------------------
    def _check_semantic_rows(self, rows: np.ndarray) -> None:
        if rows.shape[0] == 0:
            return
        if in_sorted(rows[:, 0], self.surrogate_ids).any():
            raise ValueError(
                "cannot delete surrogate-subject triples directly; delete "
                "the entity triples they factorize instead")
        if (rows[:, 1] == self.store.INSTANCE_OF).any():
            raise ValueError(
                "instanceOf links are storage artifacts, not semantic "
                "triples; delete entity triples (or entities) instead")

    def delete_triples(self, rows) -> tuple["FactorizedGraph", DeleteStats]:
        """Delete *semantic* triples from G'.

        A triple present raw in the store is simply removed.  A triple
        covered by a molecule (one of the subject's absorbed arms, or
        its moved ``type`` edge) dissolves that membership: the entity
        exits the molecule and its surviving arms re-materialize as raw
        triples.  Molecules whose support drops below the payoff
        threshold decompact in place.  Absent triples are no-ops.
        """
        rows = sort_unique(np.asarray(rows, np.int32).reshape(-1, 3),
                           SPO_PERM)
        self._check_semantic_rows(rows)
        stats = DeleteStats(n_requested=int(rows.shape[0]))
        store = self.store
        present = in_sorted(*row_keys(SPO_PERM, rows, store.spo)) \
            if store.spo.shape[0] else np.zeros(rows.shape[0], bool)
        raw_del = rows[present]
        stats.n_raw_removed = int(raw_del.shape[0])
        # molecule-covered deletions: (entity, surrogate) -> dissolved arms
        exits: dict[tuple[int, int], tuple[set, bool]] = {}
        for s, p, o in rows[~present].tolist():
            for sg in self.surrogates_of(s).tolist():
                cid, r = self.locate(sg)
                t = self.tables[cid]
                cols, type_del = exits.get((s, sg), (set(), False))
                if p == store.TYPE and o == cid:
                    exits[(s, sg)] = (cols, True)
                else:
                    j = t.col_of(p)
                    if j is not None and int(t.objects[r, j]) == o:
                        cols.add(j)
                        exits[(s, sg)] = (cols, type_del)
        stats.n_exits = len(exits)
        removed = [raw_del]
        added = []
        for (s, sg), (cols, type_del) in exits.items():
            cid, r = self.locate(sg)
            stats.note_class(cid, "exits")
            t = self.tables[cid]
            for j in range(t.k):
                if j not in cols:
                    added.append((s, t.props[j], int(t.objects[r, j])))
            if not type_del:
                added.append((s, store.TYPE, cid))
            removed.append(np.asarray([[s, store.INSTANCE_OF, sg]],
                                      np.int32))
        interim = self._apply_edits(np.concatenate(removed, axis=0)
                                    if removed else None, added)
        fg = FactorizedGraph(interim, self.tables,
                             payoff_min_support=self.payoff_min_support)
        affected = {sg for (_, sg) in exits}
        return fg._payoff_sweep(affected, stats)

    def delete_entities(self, entities) -> tuple["FactorizedGraph",
                                                 DeleteStats]:
        """Delete entities: every triple with the entity as subject OR
        object disappears semantically.  Molecules *referencing* a
        deleted entity in an arm are invalidated outright (their members
        decompact with the surviving arms); memberships of deleted
        entities dissolve and shrink supports, with the same payoff
        sweep as :meth:`delete_triples`.
        """
        ents = np.unique(np.asarray(entities, np.int64).reshape(-1))
        if in_sorted(ents, self.surrogate_ids).any():
            raise ValueError("surrogates are storage artifacts; they "
                             "disappear when their molecules do")
        stats = DeleteStats(n_requested=int(ents.shape[0]))
        store = self.store
        removed = []
        added: list[tuple[int, int, int]] = []
        new_tables = dict(self.tables)
        # 1. molecules with a deleted entity (or class) in an arm/type:
        #    the star pattern no longer exists -- invalidate in place
        for cid, t in self.tables.items():
            class_deleted = bool(in_sorted(
                np.asarray([cid], np.int64), ents)[0])
            arm_hit = in_sorted(t.objects.ravel(), ents).reshape(
                t.objects.shape)
            hit_rows = np.flatnonzero(arm_hit.any(axis=1) | class_deleted)
            if hit_rows.size == 0:
                continue
            for r in hit_rows.tolist():
                sg = int(t.surrogates[r])
                mem = self.members(sg)
                surviving = mem[~in_sorted(mem.astype(np.int64), ents)]
                for m in surviving.tolist():
                    for j in range(t.k):
                        if not arm_hit[r, j]:
                            added.append((m, t.props[j],
                                          int(t.objects[r, j])))
                    if not class_deleted:
                        added.append((m, store.TYPE, cid))
                stats.n_decompacted += int(surviving.shape[0])
                stats.note_class(cid, "decompacted",
                                 int(surviving.shape[0]))
                # surrogate rows + every member's instanceOf link go
                removed.append(self._subject_rows(sg))
                if mem.shape[0]:
                    inst = np.empty((mem.shape[0], 3), np.int32)
                    inst[:, 0] = mem
                    inst[:, 1] = store.INSTANCE_OF
                    inst[:, 2] = sg
                    removed.append(inst)
            stats.n_molecules_removed += int(hit_rows.size)
            stats.note_class(cid, "molecules_removed", int(hit_rows.size))
            new_tables[cid] = t.without_rows(hit_rows.tolist())
        # 2. raw rows touching a deleted entity (their instanceOf rows
        #    dissolve memberships -> collect affected surrogates)
        spo = store.spo
        touch = in_sorted(spo[:, 0].astype(np.int64), ents) | \
            (in_sorted(spo[:, 2].astype(np.int64), ents) &
             (spo[:, 1] != store.INSTANCE_OF))
        inst_of_deleted = (spo[:, 1] == store.INSTANCE_OF) & \
            in_sorted(spo[:, 0].astype(np.int64), ents)
        affected = set(np.unique(spo[inst_of_deleted, 2]).tolist())
        diss_sg, diss_n = np.unique(spo[inst_of_deleted, 2],
                                    return_counts=True)
        for sg, c in zip(diss_sg.tolist(), diss_n.tolist()):
            try:
                stats.note_class(self.locate(int(sg))[0], "exits", int(c))
            except KeyError:
                pass
        removed.append(spo[touch | inst_of_deleted])
        stats.n_raw_removed = int((touch | inst_of_deleted).sum())
        interim = self._apply_edits(
            np.concatenate(removed, axis=0) if removed else None, added)
        fg = FactorizedGraph(interim, new_tables,
                             payoff_min_support=self.payoff_min_support)
        return fg._payoff_sweep(affected, stats)

    def _apply_edits(self, removed_rows: np.ndarray | None,
                     added: list) -> TripleStore:
        """The store with ``removed_rows`` taken out and ``added`` merged
        in.  A plain store's live index follows the same remove-then-
        merge path (a row subset of a sorted index stays sorted), so the
        successor graph never re-sorts its whole index."""
        spo = self.store.spo
        idx = None if self.store.is_compressed else self.store._index
        if removed_rows is not None and removed_rows.shape[0]:
            spo = spo[_keep_mask(spo, removed_rows, SPO_PERM)]
            if idx is not None:
                idx = idx.filtered(_keep_mask(idx.rows, removed_rows,
                                              PSO_PERM))
        out = TripleStore.from_ids(self.store.dict, spo, presorted=True)
        out._index = idx
        if added:
            out.add_ids(np.asarray(added, np.int32).reshape(-1, 3))
        return out

    def _payoff_sweep(self, affected_sgs: set,
                      stats: DeleteStats) -> tuple["FactorizedGraph",
                                                   DeleteStats]:
        """Decompact molecules among ``affected_sgs`` whose support fell
        below ``payoff_min_support`` (Fig. 7: they now cost more edges
        than the raw representation they replaced)."""
        if not affected_sgs:
            return self, stats
        removed = []
        added: list[tuple[int, int, int]] = []
        new_tables = dict(self.tables)
        store = self.store
        affected_arr = np.asarray(sorted(affected_sgs), np.int64)
        for cid, t in self.tables.items():
            # surrogates are kept ascending: the affected subset of a
            # table is one binary-search join, not a per-molecule probe
            hit = np.flatnonzero(in_sorted(
                t.surrogates.astype(np.int64), affected_arr)).tolist()
            drop = []
            for r in hit:
                sg = int(t.surrogates[r])
                mem = self.members(sg)
                if mem.shape[0] >= self.payoff_min_support:
                    continue
                drop.append(r)
                for m in mem.tolist():
                    for j in range(t.k):
                        added.append((m, t.props[j], int(t.objects[r, j])))
                    added.append((m, store.TYPE, cid))
                stats.n_decompacted += int(mem.shape[0])
                stats.note_class(cid, "decompacted", int(mem.shape[0]))
                removed.append(self._subject_rows(sg))
                if mem.shape[0]:
                    inst = np.empty((mem.shape[0], 3), np.int32)
                    inst[:, 0] = mem
                    inst[:, 1] = store.INSTANCE_OF
                    inst[:, 2] = sg
                    removed.append(inst)
            if drop:
                stats.n_molecules_removed += len(drop)
                stats.note_class(cid, "molecules_removed", len(drop))
                new_tables[cid] = new_tables[cid].without_rows(drop)
        if not removed and not added:
            return self, stats
        out = self._apply_edits(
            np.concatenate(removed, axis=0) if removed else None, added)
        return FactorizedGraph(
            out, new_tables,
            payoff_min_support=self.payoff_min_support), stats

    def __repr__(self) -> str:  # pragma: no cover
        return (f"FactorizedGraph(n_triples={self.n_triples}, "
                f"classes={len(self.tables)}, "
                f"molecules={int(self.surrogate_ids.shape[0])})")
