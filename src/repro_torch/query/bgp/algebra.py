"""BGP algebra: multi-star basic graph patterns with FILTER constraints.

A *basic graph pattern* here is a conjunction of star patterns linked by
shared variables -- the query mixes the k2-triples / Compressed Vertical
Partitioning papers evaluate (PAPERS.md), and the shape the paper's
compaction makes cheap:

    ?o  type Observation . ?o procedure ?s . ?o samplingTime t7 .
    ?s  type Sensor      . ?s model m3 .
    FILTER(?v < val/9)

Variables are strings starting with ``"?"``; everything else in an arm
is a dictionary id (the serving layer translates terms).  A
:class:`Filter` compares a variable's *dictionary id* against a constant
with one of ``== != < <= > >=`` -- range semantics are id-order
semantics, which the synthetic generators make meaningful by minting
ordered value terms (``val/0 < val/1 < ...`` by insertion).  Every
evaluation strategy applies the same comparison, so parity between
strategies never depends on the dictionary order being "semantic".

:class:`BGPBindings` is the answer relation: one named column per query
variable, set semantics (``canonical()`` sorts-and-dedups, so digests
are strategy-order-independent -- same contract as ``star.Bindings``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

_OPS = ("==", "!=", "<", "<=", ">", ">=")


def is_var(term) -> bool:
    return isinstance(term, str) and term.startswith("?")


@dataclasses.dataclass(frozen=True)
class StarPattern:
    """One star of a BGP: a subject *variable* plus arms whose objects
    are either ground ids or variables (+ an optional class)."""

    subject: str
    arms: tuple[tuple[int, int | str], ...]
    class_id: int | None = None

    def __post_init__(self):
        if not is_var(self.subject):
            raise ValueError(f"star subject must be a ?var, got "
                             f"{self.subject!r}")
        norm = []
        for p, o in self.arms:
            if is_var(o):
                norm.append((int(p), str(o)))
            else:
                norm.append((int(p), int(o)))
        object.__setattr__(self, "arms", tuple(norm))

    @property
    def ground_arms(self) -> list[tuple[int, int]]:
        return [(p, o) for p, o in self.arms if not is_var(o)]

    @property
    def var_arms(self) -> list[tuple[int, str]]:
        return [(p, o) for p, o in self.arms if is_var(o)]

    @property
    def variables(self) -> tuple[str, ...]:
        """Variables in first-occurrence order, subject first."""
        out = [self.subject]
        for _, o in self.arms:
            if is_var(o) and o not in out:
                out.append(o)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Filter:
    """``FILTER(?v op value)`` over dictionary ids."""

    var: str
    op: str
    value: int

    def __post_init__(self):
        if not is_var(self.var):
            raise ValueError(f"filter target must be a ?var, got "
                             f"{self.var!r}")
        if self.op not in _OPS:
            raise ValueError(f"unknown filter op {self.op!r} "
                             f"(one of {_OPS})")
        object.__setattr__(self, "value", int(self.value))

    def apply(self, col: np.ndarray) -> np.ndarray:
        """Vectorized boolean mask of the constraint over an id column --
        the same comparison whether ``col`` holds one object per *entity*
        (raw / expanded evaluation) or one object per *molecule* (the
        pushed-down form: one comparison answers every member)."""
        v = self.value
        if self.op == "==":
            return col == v
        if self.op == "!=":
            return col != v
        if self.op == "<":
            return col < v
        if self.op == "<=":
            return col <= v
        if self.op == ">":
            return col > v
        return col >= v


@dataclasses.dataclass(frozen=True)
class BGPQuery:
    """A conjunction of star patterns plus filters."""

    stars: tuple[StarPattern, ...]
    filters: tuple[Filter, ...] = ()

    def __post_init__(self):
        if not self.stars:
            raise ValueError("BGP needs at least one star")
        bound = set()
        for s in self.stars:
            bound.update(s.variables)
        for f in self.filters:
            if f.var not in bound:
                raise ValueError(f"filter on unbound variable {f.var!r}")

    @property
    def variables(self) -> tuple[str, ...]:
        """All query variables, first-occurrence order across stars --
        the canonical output column order every strategy projects to."""
        out: list[str] = []
        for s in self.stars:
            for v in s.variables:
                if v not in out:
                    out.append(v)
        return tuple(out)

    def filters_on(self, var: str) -> list[Filter]:
        return [f for f in self.filters if f.var == var]


@dataclasses.dataclass
class BGPBindings:
    """Answer relation: one named column per query variable."""

    columns: tuple[str, ...]
    rows: np.ndarray                 # (R, C) int64

    def __post_init__(self):
        self.columns = tuple(self.columns)
        self.rows = np.asarray(self.rows, np.int64).reshape(
            -1, len(self.columns))

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])

    def column(self, var: str) -> np.ndarray:
        return self.rows[:, self.columns.index(var)]

    def canonical(self) -> np.ndarray:
        """Sorted-unique rows under the fixed column order -- set
        semantics, strategy-order-independent (digest input)."""
        if self.rows.shape[0] == 0:
            return self.rows
        return np.unique(self.rows, axis=0)

    def same_as(self, other: "BGPBindings") -> bool:
        if self.columns != other.columns:
            return False
        a, b = self.canonical(), other.canonical()
        return a.shape == b.shape and bool((a == b).all())
