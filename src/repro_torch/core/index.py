"""Indexed graph substrate: per-predicate CSR slices over sorted triples.

Production RDF engines (k2-triples, compressed vertical partitioning) win
by organizing the dictionary-encoded triples *per predicate*, so that
star-shaped joins become index slices instead of full-graph scans.  The
seed ``TripleStore`` answered every access -- ``entities_of_class``,
``object_matrix``, ``labeled_edge_count`` -- with O(|G|) ``np.isin`` /
``np.unique`` passes, and the greedy FSP descent re-ran them per (class,
candidate) pair: the dominant cost of detection on anything larger than
the worked examples.

``GraphIndex`` stores one extra copy of the triples, row-sorted by
``(predicate, subject, object)``, with a CSR offset table over the
predicate column:

* ``pred_slice(p)``       -- all ``(s, p, o)`` rows of predicate ``p``,
  sorted by ``(s, o)``: a vertical partition, O(log P) to locate.
* ``entities_of_class``   -- filter of the ``rdf:type`` slice; subjects
  come out sorted-unique for free (cached per class).
* ``object_matrix``       -- per-property slice joins against the sorted
  entity vector via ``searchsorted`` (no full-graph ``isin``).
* ``merged(rows)``        -- incremental merge-on-append: new rows are
  merged into the sorted order with a vectorized two-way merge
  (``searchsorted`` + fancy indexing), O(n + m log n) instead of a full
  re-sort, and per-class caches survive when untouched.

The index is immutable: ``merged`` returns a new ``GraphIndex`` sharing
nothing mutable with its parent except lazily-filled caches that remain
valid for both.  ``TripleStore`` builds one lazily and carries it across
``copy()`` / ``add_ids`` / ``restrict_subjects``.
"""
from __future__ import annotations

import numpy as np

# column permutations: spo rows are stored (s, p, o); sort keys differ
SPO_PERM = (0, 1, 2)      # TripleStore.spo canonical order
PSO_PERM = (1, 0, 2)      # GraphIndex row order

_KEY_DTYPE = np.dtype([("a", np.int32), ("b", np.int32), ("c", np.int32)])


def _key_view(rows: np.ndarray, perm) -> np.ndarray:
    """Structured (void) view of (n, 3) int32 rows under column order
    ``perm`` -- lexicographically comparable/searchable as one key."""
    arr = np.ascontiguousarray(rows[:, list(perm)], dtype=np.int32)
    return arr.view(_KEY_DTYPE).ravel()


def sort_unique(rows: np.ndarray, perm=SPO_PERM) -> np.ndarray:
    """Sort (n, 3) rows by the ``perm`` column order and drop duplicates.
    Unlike ``np.unique(axis=0)`` the key order is configurable."""
    rows = np.ascontiguousarray(rows, dtype=np.int32).reshape(-1, 3)
    if rows.shape[0] <= 1:
        return rows
    key = _key_view(rows, perm)
    order = np.argsort(key, kind="stable")
    rows = rows[order]
    keep = np.empty(rows.shape[0], bool)
    keep[0] = True
    np.any(rows[1:] != rows[:-1], axis=1, out=keep[1:])
    return rows[keep]


def setdiff_rows(new: np.ndarray, old: np.ndarray, perm=SPO_PERM
                 ) -> np.ndarray:
    """Rows of ``new`` absent from ``old`` (both sorted-unique under
    ``perm``); order of ``new`` preserved.  O(m log n)."""
    if new.shape[0] == 0 or old.shape[0] == 0:
        return new
    return new[~in_sorted(_key_view(new, perm), _key_view(old, perm))]


def merge_disjoint(old: np.ndarray, new: np.ndarray, perm=SPO_PERM
                   ) -> np.ndarray:
    """Two-way merge of disjoint row sets, each sorted-unique under
    ``perm``.  Vectorized: one ``searchsorted`` + two fancy writes --
    O(n + m log n), no re-sort, no dedup pass."""
    if new.shape[0] == 0:
        return old
    if old.shape[0] == 0:
        return new
    pos = np.searchsorted(_key_view(old, perm), _key_view(new, perm))
    out = np.empty((old.shape[0] + new.shape[0], 3), np.int32)
    new_at = pos + np.arange(new.shape[0])
    old_mask = np.ones(out.shape[0], bool)
    old_mask[new_at] = False
    out[new_at] = new
    out[old_mask] = old
    return out


def csr_take(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Flat gather indices for concatenated CSR extents: the segmented
    expansion ``[starts[i], starts[i] + counts[i])`` for every i, as one
    index vector (``arange`` minus each segment's running offset).  The
    shared idiom behind every segmented gather in this codebase --
    object-matrix extraction, instanceOf-CSR member emission, and the
    query engine's subject joins."""
    counts = np.asarray(counts)
    total = int(counts.sum())
    within = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                          counts)
    return np.repeat(starts, counts) + within


def in_sorted(values: np.ndarray, sorted_ref: np.ndarray) -> np.ndarray:
    """Membership of ``values`` in a sorted-unique 1-D ``sorted_ref``
    via binary search -- the index-join replacement for ``np.isin``
    (which re-sorts its second argument on every call)."""
    if sorted_ref.shape[0] == 0:
        return np.zeros(values.shape[0], bool)
    idx = np.searchsorted(sorted_ref, values)
    idx_c = np.minimum(idx, sorted_ref.shape[0] - 1)
    return (idx < sorted_ref.shape[0]) & (sorted_ref[idx_c] == values)


class GraphIndex:
    """Immutable per-predicate CSR index over an (n, 3) triple array."""

    __slots__ = ("rows", "preds", "starts", "type_id", "instance_of_id",
                 "_ents_cache", "_props_cache", "_classes_cache",
                 "_objsort_cache")

    def __init__(self, spo: np.ndarray, type_id: int, instance_of_id: int,
                 *, _presorted: bool = False) -> None:
        rows = np.ascontiguousarray(spo, dtype=np.int32).reshape(-1, 3)
        if not _presorted and rows.shape[0] > 1:
            order = np.argsort(_key_view(rows, PSO_PERM), kind="stable")
            rows = rows[order]
        self.rows = rows
        self.type_id = int(type_id)
        self.instance_of_id = int(instance_of_id)
        if rows.shape[0]:
            self.preds, first = np.unique(rows[:, 1], return_index=True)
            self.starts = np.append(first, rows.shape[0])
        else:
            self.preds = np.empty((0,), np.int32)
            self.starts = np.zeros((1,), np.int64)
        self._ents_cache: dict[int, np.ndarray] = {}
        self._props_cache: dict[int, np.ndarray] = {}
        self._classes_cache: np.ndarray | None = None
        self._objsort_cache: dict[int, np.ndarray] = {}

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])

    # -- slices ------------------------------------------------------------
    def pred_slice(self, p: int) -> np.ndarray:
        """All rows with predicate ``p``, sorted by (s, o).  A view."""
        i = int(np.searchsorted(self.preds, p))
        if i >= self.preds.shape[0] or self.preds[i] != p:
            return self.rows[:0]
        return self.rows[self.starts[i]:self.starts[i + 1]]

    def pred_subjects(self, p: int) -> np.ndarray:
        """Subject column of one predicate's partition (non-decreasing).
        The accessor the compressed tier can answer by decoding ONE
        delta-packed column -- callers must prefer it over slicing
        ``rows`` directly."""
        return self.pred_slice(p)[:, 0]

    # -- storage accounting ------------------------------------------------
    def nbytes(self) -> int:
        """Resident bytes of the index arrays (the uncompressed-tier
        denominator of the bytes-per-triple bench column)."""
        return int(self.rows.nbytes) + int(self.preds.nbytes) \
            + int(self.starts.nbytes)

    # -- selectivity -------------------------------------------------------
    def pred_count(self, p: int) -> int:
        """Row count of a predicate's vertical partition: the size of
        the slice a raw ground-arm scan pays -- a planner cost input."""
        i = int(np.searchsorted(self.preds, p))
        if i >= self.preds.shape[0] or self.preds[i] != p:
            return 0
        return int(self.starts[i + 1] - self.starts[i])

    def pred_objects_sorted(self, p: int) -> np.ndarray:
        """Sorted object column of one predicate (cached): two binary
        searches answer any equality or range selectivity probe."""
        arr = self._objsort_cache.get(int(p))
        if arr is None:
            arr = np.sort(self.pred_slice(p)[:, 2].astype(np.int64))
            self._objsort_cache[int(p)] = arr
        return arr

    def pred_object_count(self, p: int, o: int) -> int:
        """Triples matching ``(?s p o)`` -- the ground-arm selectivity
        numerator, O(log) off the sorted-object cache."""
        arr = self.pred_objects_sorted(p)
        return int(np.searchsorted(arr, o, side="right")
                   - np.searchsorted(arr, o, side="left"))

    # -- class / schema ----------------------------------------------------
    def entities_of_class(self, class_id: int) -> np.ndarray:
        """Sorted-unique subjects with ``(s, type, class_id)``.  The type
        slice is (s, o)-sorted and triple-deduped, so filtering by object
        keeps subjects strictly increasing: no ``np.unique`` needed."""
        ents = self._ents_cache.get(class_id)
        if ents is None:
            ts = self.pred_slice(self.type_id)
            ents = ts[ts[:, 2] == class_id, 0]
            self._ents_cache[class_id] = ents
        return ents

    def classes(self) -> np.ndarray:
        if self._classes_cache is None:
            ts = self.pred_slice(self.type_id)
            self._classes_cache = np.unique(ts[:, 2])
        return self._classes_cache

    def class_properties(self, class_id: int) -> np.ndarray:
        """Sorted property ids with >= 1 subject in class C, excluding
        ``type`` / ``instanceOf`` -- one membership probe per vertical
        partition instead of a full-graph scan."""
        props = self._props_cache.get(class_id)
        if props is None:
            ents = self.entities_of_class(class_id)
            out = []
            for i, p in enumerate(self.preds.tolist()):
                if p == self.type_id or p == self.instance_of_id:
                    continue
                subs = self.rows[self.starts[i]:self.starts[i + 1], 0]
                if ents.shape[0] and in_sorted(subs, ents).any():
                    out.append(p)
            props = np.asarray(out, dtype=self.preds.dtype)
            self._props_cache[class_id] = props
        return props

    # -- joins -------------------------------------------------------------
    def object_matrix(self, class_id: int, props, strict: bool = False
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Entities x objects matrix via ONE fused segmented gather.

        Semantics match the scan-based ``TripleStore.object_matrix``:
        entities violating the complete-molecule / functional-property
        assumption (§4.3 (a)/(b)) are excluded (``strict=True`` raises).
        All requested predicates' CSR extents are located at once and
        their rows pulled in a single fancy-index over the sorted layout,
        followed by one combined subject join and one flat ``bincount``
        -- O(sum_p |G_p| log |C|) work with O(|SP|) python overhead
        instead of O(|SP|) sequential per-predicate joins.
        """
        props = np.asarray(list(props), dtype=np.int32)
        ents = self.entities_of_class(class_id)
        if ents.size == 0 or props.size == 0:
            return ents[:0], np.empty((0, props.size), np.int32)
        objmat = np.full((ents.size, props.size), -1, dtype=np.int32)
        counts = np.zeros((ents.size, props.size), np.int64)
        # locate every predicate's extent in the offset table at once
        pi = np.searchsorted(self.preds, props)
        pi_c = np.minimum(pi, self.preds.shape[0] - 1)
        present = (pi < self.preds.shape[0]) & (self.preds[pi_c] == props)
        starts = np.where(present, self.starts[pi_c], 0)
        lengths = np.where(present, self.starts[pi_c + 1] - starts, 0)
        total = int(lengths.sum())
        if total:
            # segmented gather: concatenated per-predicate extents become
            # one row-index vector (start offset + within-segment rank)
            col = np.repeat(np.arange(props.size), lengths)
            sub = self.rows[csr_take(starts, lengths)]
            idx = np.searchsorted(ents, sub[:, 0])
            idx_c = np.minimum(idx, ents.size - 1)
            hit = (idx < ents.size) & (ents[idx_c] == sub[:, 0])
            ei, cj = idx_c[hit], col[hit]
            counts = np.bincount(
                ei * props.size + cj,
                minlength=ents.size * props.size,
            ).reshape(ents.size, props.size)
            objmat[ei, cj] = sub[hit, 2]
        complete = (counts == 1).all(axis=1)
        if strict and not complete.all():
            bad = ents[~complete]
            raise ValueError(
                f"{bad.size} entities of class {class_id} violate the "
                "complete-molecule/functional-property assumption")
        return ents[complete], objmat[complete]

    def labeled_edge_count(self, class_id: int, props=None) -> int:
        """NLE restricted to class C (paper §5): membership counts per
        vertical partition instead of a full-graph ``isin``."""
        ents = self.entities_of_class(class_id)
        if ents.shape[0] == 0:
            return 0
        if props is not None:
            pids = [int(p) for p in props]
        else:
            pids = [int(p) for p in self.preds.tolist() if p != self.type_id]
        total = 0
        for p in pids:
            sl = self.pred_slice(p)
            if sl.shape[0]:
                total += int(in_sorted(sl[:, 0], ents).sum())
        return total

    # -- incremental maintenance --------------------------------------------
    def filtered(self, keep: np.ndarray) -> "GraphIndex":
        """New index over ``rows[keep]`` -- a row-subset of a sorted array
        stays sorted, so this is O(n) with no re-sort (caches are dropped:
        the caller decides which classes survive a removal)."""
        out = GraphIndex.__new__(GraphIndex)
        GraphIndex.__init__(out, self.rows[keep], self.type_id,
                            self.instance_of_id, _presorted=True)
        return out

    def merged(self, new_rows: np.ndarray) -> "GraphIndex":
        """New index over ``rows + new_rows`` without a full re-sort.

        ``new_rows`` may be unsorted and overlap existing rows; they are
        locally sorted/deduped (O(m log m)), subtracted, and merged into
        the (p, s, o) order in one vectorized pass.  Caches carry over for
        classes provably untouched by the appended rows.
        """
        nr = sort_unique(new_rows, PSO_PERM)
        nr = setdiff_rows(nr, self.rows, PSO_PERM)
        out = GraphIndex.__new__(GraphIndex)
        GraphIndex.__init__(
            out, merge_disjoint(self.rows, nr, PSO_PERM),
            self.type_id, self.instance_of_id, _presorted=True)
        if nr.shape[0] == 0:
            out._ents_cache = dict(self._ents_cache)
            out._props_cache = dict(self._props_cache)
            out._classes_cache = self._classes_cache
            return out
        touched_classes = set(
            nr[nr[:, 1] == self.type_id, 2].tolist())
        new_subjects = np.unique(nr[:, 0])
        for cid, ents in self._ents_cache.items():
            if cid in touched_classes:
                continue
            out._ents_cache[cid] = ents
            # property sets stay valid only if no appended row's subject
            # is an entity of the class (new preds on members invalidate)
            if cid in self._props_cache and \
                    not in_sorted(new_subjects, ents).any():
                out._props_cache[cid] = self._props_cache[cid]
        if not touched_classes and self._classes_cache is not None:
            out._classes_cache = self._classes_cache
        return out
