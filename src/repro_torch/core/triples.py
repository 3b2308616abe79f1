"""Dictionary-encoded RDF triple store.

The paper (Karim et al. 2020) operates on RDF graphs ``G = (V, E, L)``
(Def. 4.2).  Like every production RDF engine (HDT, k2-triples, ...), we
dictionary-encode terms at ingest: URIs / literals become dense int32 ids, and
the graph is a single ``(n, 3)`` COO array of ``(subject, property, object)``
ids.  All downstream computation (multiplicity, AMI, #Edges, factorization)
is vectorized over these arrays, which is also the layout we ship to device.

Access paths are served by a lazily-built :class:`repro_torch.core.index.GraphIndex`
(per-predicate CSR slices over a (p, s, o)-sorted copy): class membership,
class schema, object-matrix extraction and edge counting are index joins,
not full-graph scans.  The index survives ``copy()`` and is *merged* --
not rebuilt -- on ``add_ids``, so streaming appends never re-sort the whole graph.

Two ids are reserved with well-known terms:
  * ``rdf:type``           -- the class-membership property (paper: "type")
  * ``repro:instanceOf``   -- the surrogate-link property added by
                              factorization (paper Def. 4.10/4.11)
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from .. import obs
from .index import (GraphIndex, SPO_PERM, in_sorted, merge_disjoint,
                    setdiff_rows, sort_unique)

RDF_TYPE = "rdf:type"
INSTANCE_OF = "repro:instanceOf"


class TermDict:
    """Bidirectional term <-> id dictionary (host side)."""

    __slots__ = ("_terms", "_index")

    def __init__(self) -> None:
        self._terms: list[str] = []
        self._index: dict[str, int] = {}

    def id(self, term: str) -> int:
        """Return the id of ``term``, allocating one if unseen."""
        i = self._index.get(term)
        if i is None:
            i = len(self._terms)
            self._index[term] = i
            self._terms.append(term)
        return i

    def ids(self, terms: Sequence[str]) -> np.ndarray:
        """Bulk id allocation: the batched counterpart of :meth:`id`.

        Unseen terms receive a contiguous id block appended in one shot
        (one list ``extend`` + one dict ``update`` instead of per-term
        lookup/append/insert round-trips) -- the surrogate-minting path of
        Algorithm 3 allocates one id per star pattern and dominates
        factorization setup time at scale (benchmarked in
        ``benchmarks/bench_savings.py``).

        Returns int32, matching ``TripleStore.spo``: minted ids flow
        straight into triple rows (``from_ids`` / ``add_ids``) and a wider
        dtype would silently upcast every downstream concatenation.
        """
        index = self._index
        missing = dict.fromkeys(t for t in terms if t not in index)
        if missing:
            base = len(self._terms)
            self._terms.extend(missing)
            index.update(zip(missing, range(base, base + len(missing))))
        return np.fromiter((index[t] for t in terms), np.int32,
                           count=len(terms))

    @classmethod
    def from_terms(cls, terms: Iterable[str]) -> "TermDict":
        """Rebuild a dictionary from its term list, ids = positions.

        Ids are implied by allocation order, so restoring the exact list
        restores the exact id assignment (``repro_torch.convert`` carries
        a dictionary across this way)."""
        d = cls()
        d._terms = list(terms)
        d._index = {t: i for i, t in enumerate(d._terms)}
        if len(d._index) != len(d._terms):
            raise ValueError("duplicate terms in from_terms input")
        return d

    def lookup(self, term: str) -> int | None:
        return self._index.get(term)

    def term(self, i: int) -> str:
        return self._terms[i]

    def terms(self, ids) -> list[str]:
        """The terms of an id array, in its order (one list walk)."""
        t = self._terms
        return [t[i] for i in np.asarray(ids).reshape(-1).tolist()]

    def decode_rows(self, rows) -> list[tuple[str, ...]]:
        """An (R, C) id array as R tuples of C terms."""
        rows = np.asarray(rows)
        if rows.shape[1] == 0:
            return [()] * rows.shape[0]
        return list(zip(*(self.terms(rows[:, j])
                          for j in range(rows.shape[1]))))

    def __len__(self) -> int:
        return len(self._terms)

    def __contains__(self, term: str) -> bool:
        return term in self._index

    def nbytes(self) -> int:
        """Approximate resident bytes of the term storage: per-string
        UTF-8 payload plus CPython object + dict-slot overhead.  The
        uncompressed-tier denominator for the dictionary share of
        ``substrate_nbytes``."""
        # ~49 bytes str object header + ~104 bytes amortized dict entry
        # (key slot in _index + list slot in _terms), measured on CPython
        # 3.11 via sys.getsizeof over the bench dictionaries
        payload = sum(len(t.encode("utf-8")) for t in self._terms)
        return payload + 153 * len(self._terms)


@dataclasses.dataclass
class ClassStats:
    """Per-class statistics used throughout the paper's formulas."""

    class_id: int
    n_instances: int          # AM_G(C) -- Def. 4.8
    properties: np.ndarray    # sorted property ids with domain C (excl. type)


class TripleStore:
    """An RDF graph as dictionary-encoded COO triples.

    ``spo`` is an ``(n, 3)`` int32 array; row ``(s, p, o)`` is the RDF triple
    / labeled edge of Def. 4.1/4.2.  Duplicate triples are removed (an RDF
    graph is a *set* of triples) and rows are kept sorted by (s, p, o) --
    the invariant that lets appends merge instead of re-sort.
    """

    def __init__(self, dictionary: TermDict | None = None,
                 spo: np.ndarray | None = None, *,
                 presorted: bool = False) -> None:
        self._index: GraphIndex | None = None
        self.dict = dictionary if dictionary is not None else TermDict()
        self.TYPE = self.dict.id(RDF_TYPE)
        self.INSTANCE_OF = self.dict.id(INSTANCE_OF)
        if spo is None:
            spo = np.empty((0, 3), dtype=np.int32)
        spo = np.asarray(spo, dtype=np.int32).reshape(-1, 3)
        # ``presorted=True``: caller guarantees sorted-unique (s, p, o)
        # rows (e.g. a row-subset of another store) -- skip the dedup sort
        self._spo = spo if presorted else sort_unique(spo, SPO_PERM)

    # -- storage invariants ------------------------------------------------
    @property
    def spo(self) -> np.ndarray:
        return self._spo

    @spo.setter
    def spo(self, rows: np.ndarray) -> None:
        # rebinding the triple array invalidates the index (callers that
        # append should prefer ``add_ids``, which merges instead)
        self._spo = sort_unique(np.asarray(rows, np.int32).reshape(-1, 3),
                                SPO_PERM)
        self._index = None

    @property
    def index(self) -> GraphIndex:
        """The lazily-built per-predicate CSR index over ``spo``."""
        if self._index is None:
            with obs.span("index.build", rows=self.n_triples):
                self._index = GraphIndex(self._spo, self.TYPE,
                                         self.INSTANCE_OF)
        return self._index

    # -- construction ------------------------------------------------------
    @classmethod
    def from_triples(cls, triples: Iterable[tuple[str, str, str]]) -> "TripleStore":
        store = cls()
        d = store.dict
        rows = [(d.id(s), d.id(p), d.id(o)) for s, p, o in triples]
        store.spo = np.asarray(rows, dtype=np.int32).reshape(-1, 3)
        return store

    @classmethod
    def from_ids(cls, dictionary: TermDict, spo: np.ndarray, *,
                 presorted: bool = False) -> "TripleStore":
        return cls(dictionary, spo, presorted=presorted)

    def add_ids(self, rows: np.ndarray) -> None:
        """Append triples, preserving the sorted-unique invariant by
        *merging*: the incoming block is locally sorted/deduped, rows
        already present are dropped with a binary-search pass, and the
        disjoint remainder merges in O(n + m log n) -- no ``np.unique``
        over the combined graph.  A live index is merged incrementally."""
        rows = np.asarray(rows, dtype=np.int32).reshape(-1, 3)
        if rows.shape[0] == 0:
            return
        if self._spo.shape[0] == 0:
            self._spo = sort_unique(rows, SPO_PERM)
            self._index = None
            return
        fresh = setdiff_rows(sort_unique(rows, SPO_PERM), self._spo, SPO_PERM)
        if fresh.shape[0] == 0:
            return
        self._spo = merge_disjoint(self._spo, fresh, SPO_PERM)
        if self._index is not None:
            self._index = self._index.merged(fresh)

    def restrict_subjects(self, subjects: np.ndarray) -> "TripleStore":
        """Subgraph of triples whose subject is in ``subjects`` (shared
        dictionary) -- the paper evaluates each observation type as its
        own graph.  A row-subset of a sorted-unique array stays
        sorted-unique, so the result skips the dedup pass entirely."""
        subjects = np.unique(np.asarray(subjects).ravel())
        mask = in_sorted(self._spo[:, 0], subjects)
        return TripleStore.from_ids(self.dict, self._spo[mask],
                                    presorted=True)

    # -- size metrics (paper §5, "Metrics") --------------------------------
    def substrate_nbytes(self, include_dict: bool = True) -> int:
        """Deterministic resident-bytes accounting of the serving
        substrate: triple rows + CSR index (built if absent) + term
        dictionary.  The bytes-per-triple bench column compares this
        across tiers -- unlike RSS it is allocator- and GC-independent."""
        total = int(self._spo.nbytes) + self.index.nbytes()
        if include_dict:
            total += self.dict.nbytes()
        return total

    def compressed(self, *, max_resident: int = 8,
                   compact_dict: bool = True) -> "TripleStore":
        """This graph re-hosted on the compressed tier (bit-packed
        delta-encoded CSR partitions + front-coded dictionary) behind
        the same accessor surface.  Ids are preserved, so detect/query
        results and digests are identical."""
        from .compress import compress_store
        return compress_store(self, max_resident=max_resident,
                              compact_dict=compact_dict)

    @property
    def is_compressed(self) -> bool:
        """Tier predicate: ``True`` on the compressed tier (overridden
        there)."""
        return False

    @property
    def n_triples(self) -> int:
        return int(self._spo.shape[0])

    def nodes(self) -> np.ndarray:
        """Distinct entity/object nodes (NN numerator)."""
        if not len(self._spo):
            return np.empty((0,), np.int32)
        return np.unique(np.concatenate([self._spo[:, 0], self._spo[:, 2]]))

    @property
    def n_nodes(self) -> int:
        return int(self.nodes().shape[0])

    @property
    def size(self) -> int:
        """Graph size = #nodes + #edges (paper §5 'Metrics')."""
        return self.n_nodes + self.n_triples

    # -- class / schema access ---------------------------------------------
    def entities_of_class(self, class_id: int) -> np.ndarray:
        return self.index.entities_of_class(int(class_id))

    def classes(self) -> np.ndarray:
        return self.index.classes()

    def class_properties(self, class_id: int) -> np.ndarray:
        """Sorted property ids whose domain includes class C (excl. type &
        instanceOf)."""
        return self.index.class_properties(int(class_id))

    def class_stats(self, class_id: int) -> ClassStats:
        ents = self.entities_of_class(class_id)
        return ClassStats(class_id=class_id, n_instances=int(ents.shape[0]),
                          properties=self.class_properties(class_id))

    # -- molecule access -----------------------------------------------------
    def object_matrix(self, class_id: int, props: Sequence[int],
                      strict: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Entities x objects matrix for a (class, property-set) pair.

        Returns ``(entities, objmat)`` with ``objmat[i, j]`` = object of
        ``props[j]`` on ``entities[i]``.  The paper's algorithms assume RDF
        molecules are *complete* (every entity has a value for every property)
        and properties are *functional* (one value each) -- assumption (a)/(b)
        of §4.3.  We validate: entities violating either assumption are
        excluded from the candidate set (``strict=True`` raises instead).
        Served by per-predicate index joins (see ``core.index``).
        """
        return self.index.object_matrix(int(class_id), props, strict=strict)

    def object_table(self, class_id: int, props: Sequence[int]
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
        """Every entity of the class over ``props``, with the mask of
        exactly one object and the class's rows per property
        (``GraphIndex.object_table``): what the detectors score a star on
        where molecules are incomplete or properties multi-valued."""
        return self.index.object_table(int(class_id), props)

    def labeled_edge_count(self, class_id: int,
                           props: Sequence[int] | None = None) -> int:
        """NLE: labeled edges annotated with class properties (paper §5)."""
        return self.index.labeled_edge_count(int(class_id), props)

    # -- convenience ---------------------------------------------------------
    def triples_as_terms(self) -> list[tuple[str, str, str]]:
        t = self.dict.term
        return [(t(s), t(p), t(o)) for s, p, o in self._spo.tolist()]

    def copy(self) -> "TripleStore":
        new = TripleStore.__new__(TripleStore)
        new.dict = self.dict          # term dict is shared (append-only)
        new.TYPE = self.TYPE
        new.INSTANCE_OF = self.INSTANCE_OF
        new._spo = self._spo.copy()
        new._index = self._index      # immutable: valid for equal rows
        return new

    def __repr__(self) -> str:  # pragma: no cover
        return f"TripleStore(n_triples={self.n_triples}, n_nodes={self.n_nodes})"
