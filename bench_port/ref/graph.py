"""Plain numpy access to a graph's id rows: what the generator and the
reference share.  Nothing here imports the
program."""
from __future__ import annotations

import numpy as np


def sort_unique(rows: np.ndarray) -> np.ndarray:
    """The sorted (s, p, o), duplicate-free rows of an (n, 3) array."""
    rows = np.asarray(rows, np.int64).reshape(-1, 3)
    if rows.shape[0] == 0:
        return rows
    rows = rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]
    keep = np.ones(rows.shape[0], bool)
    keep[1:] = (rows[1:] != rows[:-1]).any(axis=1)
    return rows[keep]


def rows_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Rows in exactly one of two sorted-unique row arrays of one width
    (the size of their symmetric difference)."""
    a = np.ascontiguousarray(np.asarray(a, np.int64))
    b = np.ascontiguousarray(np.asarray(b, np.int64))
    if a.shape == b.shape and np.array_equal(a, b):
        return 0
    if a.shape[0] == 0 or b.shape[0] == 0:
        return int(a.shape[0] + b.shape[0])
    if a.shape[1] != b.shape[1]:
        return int(a.shape[0] + b.shape[0])
    void = np.dtype((np.void, 8 * a.shape[1]))
    av, bv = a.view(void).ravel(), b.view(void).ravel()
    both = np.intersect1d(av, bv, assume_unique=True).shape[0]
    return int(a.shape[0] + b.shape[0] - 2 * both)


class Graph:
    """Rows grouped by predicate, each block sorted by (subject, object),
    built once: every per-predicate lookup is a slice."""

    def __init__(self, spo: np.ndarray, type_id: int = 0) -> None:
        spo = np.asarray(spo, np.int64).reshape(-1, 3)
        spo = spo[np.lexsort((spo[:, 2], spo[:, 0], spo[:, 1]))]
        keep = np.ones(spo.shape[0], bool)
        keep[1:] = (spo[1:] != spo[:-1]).any(axis=1)
        self.spo = spo[keep]                  # a graph is a set of triples
        self.type_id = int(type_id)
        self.preds, starts = np.unique(self.spo[:, 1], return_index=True)
        self.starts = np.append(starts, self.spo.shape[0])
        self._classes: dict[int, np.ndarray] = {}

    def pred(self, p: int) -> tuple[np.ndarray, np.ndarray]:
        """(subjects, objects) of predicate ``p``, sorted by (s, o)."""
        i = int(np.searchsorted(self.preds, p))
        if i >= self.preds.shape[0] or self.preds[i] != p:
            z = np.empty((0,), np.int64)
            return z, z
        blk = self.spo[self.starts[i]:self.starts[i + 1]]
        return blk[:, 0], blk[:, 2]

    def entities(self, class_id: int) -> np.ndarray:
        """Sorted subjects typed ``class_id``."""
        c = int(class_id)
        if c not in self._classes:
            s, o = self.pred(self.type_id)
            self._classes[c] = np.unique(s[o == c])
        return self._classes[c]

    def classes(self) -> np.ndarray:
        return np.unique(self.pred(self.type_id)[1])

    def class_properties(self, class_id: int,
                         skip: tuple[int, ...] = ()) -> np.ndarray:
        """Sorted predicates (other than ``rdf:type`` and ``skip``) with at
        least one subject in the class."""
        ents = self.entities(class_id)
        out = []
        for p in self.preds.tolist():
            if p == self.type_id or p in skip:
                continue
            s, _ = self.pred(p)
            if ents.shape[0] and np.isin(s, ents).any():
                out.append(p)
        return np.asarray(out, np.int64)

    def object_counts(self, class_id: int, props
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(entities, counts, objects) of the class's entities over
        ``props``: ``counts[i, j]`` is how many objects entity ``i`` has
        for ``props[j]``, and ``objects[i, j]`` the first of them (-1
        where it has none)."""
        ents = self.entities(class_id)
        props = [int(p) for p in props]
        count = np.zeros((ents.shape[0], len(props)), np.int64)
        mat = np.full((ents.shape[0], len(props)), -1, np.int64)
        for j, p in enumerate(props):
            s, o = self.pred(p)
            lo = np.searchsorted(s, ents, "left")
            hi = np.searchsorted(s, ents, "right")
            count[:, j] = hi - lo
            has = hi > lo
            mat[has, j] = o[lo[has]]
        return ents, count, mat

    def object_matrix(self, class_id: int, props) -> tuple[np.ndarray,
                                                           np.ndarray]:
        """(entities, objects) of the class's entities that carry exactly
        one object for every property of ``props`` (the complete,
        functional molecules); ``objects[i, j]`` is the object of
        ``props[j]``."""
        ents, count, mat = self.object_counts(class_id, props)
        ok = (count == 1).all(axis=1)
        return ents[ok], mat[ok]
