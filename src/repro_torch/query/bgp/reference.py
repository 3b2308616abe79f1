"""Reference BGP evaluator: the semantics oracle for property tests.

Deliberately shares **no** join or deferral machinery with ``exec``:
each star evaluates with ``eval_raw`` over a *plain* store (the
``expand()`` of the graph under test), stars combine with a plain
python hash join, and filters apply last on fully materialized rows.
Slow and obviously-correct; ``tests/test_torch_bgp.py`` asserts every
engine strategy (planner-chosen, fixed-raw, fixed-factorized, with and
without filters) produces the same canonical binding set.
"""
from __future__ import annotations

import numpy as np

from ...core.triples import TripleStore

from ..star import eval_raw
from .algebra import BGPBindings, BGPQuery, StarPattern, is_var


def _star_rows(store: TripleStore, star: StarPattern
               ) -> tuple[tuple[str, ...], list[tuple[int, ...]]]:
    from ..star import StarQuery
    q = StarQuery(
        arms=tuple((p, None if is_var(o) else int(o)) for p, o in star.arms),
        class_id=star.class_id)
    b = eval_raw(store, q)
    cols = (star.subject,) + tuple(v for _, v in star.var_arms)
    rows = []
    for row in b.rows().tolist():
        # repeated variables inside a star must bind equal values
        env: dict[str, int] = {}
        ok = True
        for v, val in zip(cols, row):
            if v in env and env[v] != val:
                ok = False
                break
            env[v] = int(val)
        if ok:
            rows.append(env)
    keep = []
    seen = set()
    for v in cols:
        if v not in seen:
            seen.add(v)
            keep.append(v)
    return tuple(keep), [tuple(e[v] for v in keep) for e in rows]


def eval_bgp_reference(store: TripleStore, query: BGPQuery) -> BGPBindings:
    """Evaluate a BGP on a plain store by per-star raw evaluation and
    nested hash joins, filters applied post-hoc."""
    cols: tuple[str, ...] = ()
    rows: list[tuple[int, ...]] = []
    for si, star in enumerate(query.stars):
        scols, srows = _star_rows(store, star)
        if si == 0:
            cols, rows = scols, srows
            continue
        shared = [v for v in scols if v in cols]
        new = [v for v in scols if v not in cols]
        idx_a = [cols.index(v) for v in shared]
        idx_s = [scols.index(v) for v in shared]
        idx_new = [scols.index(v) for v in new]
        table: dict[tuple, list[tuple]] = {}
        for r in srows:
            table.setdefault(tuple(r[j] for j in idx_s), []).append(
                tuple(r[j] for j in idx_new))
        joined = []
        for r in rows:
            for ext in table.get(tuple(r[j] for j in idx_a), ()):
                joined.append(r + ext)
        cols = cols + tuple(new)
        rows = joined
    out = []
    for r in rows:
        env = dict(zip(cols, r))
        if all(f.apply(np.asarray([env[f.var]]))[0]
               for f in query.filters):
            out.append(r)
    arr = (np.asarray(out, np.int64) if out
           else np.empty((0, len(cols)), np.int64))
    perm = [cols.index(v) for v in query.variables]
    return BGPBindings(query.variables, arr[:, perm])
