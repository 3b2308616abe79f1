"""The reference's objective: a star pattern is scored on the entities
its factorization folds.  A class whose molecules are never complete
is not planned, an optional property is scored on the entities that
hold it, and on LUBM graphs (multi-valued and optional properties,
graduates typed twice) every planned class folds something, its
predicted savings are the rows its factorization removes, also after an
earlier class folded some of its entities, and G' expands back to G."""
import itertools

import numpy as np
import pytest

from bench_port.gen import lubm as L
from bench_port.gen.sensor import seeded_rng
from bench_port.ref import fsp
from bench_port.ref.graph import Graph, rows_diff, sort_unique

TYPE, INST, CLS = 0, 1, 2
P0 = 3                       # the first predicate id; objects follow


def _arms(ents, p, objs):
    return np.stack([ents, np.full(len(ents), p), objs], 1)


def _class_rows(rng, n, props):
    """One class of ``n`` entities; ``props`` maps a predicate offset to
    a function of the rng giving (subject index, object) pairs."""
    obj0 = P0 + len(props)
    ents = obj0 + 10_000 + np.arange(n)
    parts = [_arms(ents, TYPE, np.full(n, CLS))]
    for j, draw in enumerate(props):
        idx, objs = draw(rng, n)
        parts.append(_arms(ents[idx], P0 + j, obj0 + 1000 * j + objs))
    rows = np.concatenate(parts)
    return rows, obj0 + 10_000 + n


def _one(k):
    return lambda rng, n: (np.arange(n), rng.integers(0, k, n))


def _unique(rng, n):
    return np.arange(n), np.arange(n)


def _multi(lo, hi, k):
    """``lo``-``hi`` distinct objects of ``k`` for every entity."""
    def draw(rng, n):
        take = rng.integers(lo, hi + 1, n)
        keys = rng.random((n, k)).argsort(axis=1)
        idx = np.repeat(np.arange(n), take)
        return idx, keys[idx, np.concatenate([np.arange(t) for t in take])]
    return draw


def _optional(share, k):
    def draw(rng, n):
        idx = np.flatnonzero(rng.random(n) < share)
        return idx, rng.integers(0, k, idx.shape[0])
    return draw


def _removed(rows, entries, n_terms):
    """Rows each entry's factorization removes, in plan order."""
    sizes = [sort_unique(rows).shape[0]]
    for i in range(len(entries)):
        gp, _ = fsp.factorize(rows, entries[:i + 1], n_terms, TYPE, INST)
        sizes.append(gp.shape[0])
    return [a - b for a, b in zip(sizes, sizes[1:])]


@pytest.mark.parametrize("detector", ["gfsp", "efsp"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_a_class_whose_molecules_are_never_complete_is_not_planned(
        seed, detector):
    # memberOf (one of 5), name (unique), takesCourse (2-4 of 20): no
    # entity has one object for all three, and dropping takesCourse
    # leaves a unique name in every tuple
    rng = seeded_rng(seed)
    rows, _ = _class_rows(rng, 400, [_one(5), _unique, _multi(2, 4, 20)])
    g = Graph(rows, TYPE)
    view = fsp.ClassView(g, CLS, g.class_properties(CLS, (INST,)))
    assert view.total == 800 + int((rows[:, 1] == P0 + 2).sum())
    # S folds no entity: AMI 0, #Edges the baseline, nothing saved
    assert view.score([0, 1, 2]) == (view.total, 0, 0)
    assert fsp.plan(g, INST, detector=detector) == []


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_an_optional_property_is_scored_on_the_entities_that_hold_it(
        seed):
    # dept (one of 4), a constant telephone, an advisor (one of 3) on
    # one entity in five
    rng = seeded_rng(seed)
    rows, n_terms = _class_rows(rng, 500, [_one(4), _one(1),
                                           _optional(0.2, 3)])
    g = Graph(rows, TYPE)
    view = fsp.ClassView(g, CLS, g.class_properties(CLS, (INST,)))
    advised = np.flatnonzero(view.count[:, 2] == 1)
    assert 40 < advised.shape[0] < 160
    tuples = {tuple(r) for r in view.obj[advised][:, [0, 2]].tolist()}
    n_e, a = advised.shape[0], len(tuples)
    assert view.score([0, 2]) == (a * 3 + view.total - 2 * n_e, a, n_e)
    assert view.total == 1000 + n_e
    for detector in ("gfsp", "efsp"):
        (entry,) = fsp.plan(g, INST, detector=detector)
        # every entity holds dept and telephone: 4 molecules of all 500
        assert entry.props == (P0, P0 + 1) and entry.ami == 4
        saved = entry.baseline_edges - entry.predicted_edges
        assert saved == 500 * 2 - 4 * 3
        assert _removed(rows, [entry], n_terms) == [saved]


def _lubm(seed):
    spec = L.LubmSpec(1)
    v = L.Vocabulary(spec)
    return v, L.graph_rows(v, spec, seeded_rng(seed))


@pytest.mark.parametrize("detector", ["gfsp", "efsp"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_on_lubm_graphs_every_planned_class_folds_what_it_predicts(
        seed, detector):
    v, rows = _lubm(seed)
    g = Graph(rows, TYPE)
    entries = fsp.plan(g, INST, detector=detector)
    n_terms = len(v.terms)
    gp, tables = fsp.factorize(rows, entries, n_terms, TYPE, INST)
    assert [e.class_id for e in entries] == list(tables)
    for e in entries:
        assert tables[e.class_id].surrogates.shape[0] >= 1
    removed = _removed(rows, entries, n_terms)
    assert removed == [e.baseline_edges - e.predicted_edges
                       for e in entries]
    assert rows_diff(fsp.expand(gp, TYPE, INST), sort_unique(rows)) == 0
    # graduates typed twice keep both types through G'
    twice = np.intersect1d(g.entities(v.id("GraduateStudent")),
                           g.entities(v.id("TeachingAssistant")))
    assert twice.shape[0] > 0
    if detector == "gfsp":
        # each person class has a unique e-mail, and a unique name within
        # its department: no single drop lowers AMI
        assert entries == []
    else:
        planned = {v.terms[e.class_id] for e in entries}
        assert {"ub:UndergraduateStudent", "ub:GraduateStudent"} <= planned
        # the assistants' patterns share properties with the graduates'
        # pattern, which folds them first
        assert not planned & {"ub:TeachingAssistant", "ub:ResearchAssistant"}


@pytest.mark.parametrize("detector", ["gfsp", "efsp"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_a_class_sharing_entities_with_an_earlier_one_is_scored_on_the_rest(
        seed, detector):
    # classes 2 and 3 share entities 300-599 and both find SP = (dept,
    # year); class 2 ranks first (a tie, class order), folds them, and
    # class 3 keeps and reports only its other 300
    rng = seeded_rng(seed)
    n = 900
    ents = P0 + 2 + 100 + np.arange(n)
    rows = np.concatenate([
        _arms(ents[:600], TYPE, np.full(600, CLS)),
        _arms(ents[300:], TYPE, np.full(600, CLS + 1)),
        _arms(ents, P0, P0 + 2 + rng.integers(0, 3, n)),
        _arms(ents, P0 + 1, P0 + 2 + 3 + rng.integers(0, 2, n))])
    n_terms = int(rows.max()) + 1
    g = Graph(rows, TYPE)
    first, second = fsp.plan(g, INST, detector=detector)
    assert (first.class_id, second.class_id) == (CLS, CLS + 1)
    assert first.props == second.props == (P0, P0 + 1)
    assert first.baseline_edges == second.baseline_edges == 1200
    rest = ents[600:]
    arms = sort_unique(rows[np.isin(rows[:, 0], rest)
                            & (rows[:, 1] != TYPE)])   # p0, p1 an entity
    want = {tuple(r) for r in arms[:, 2].reshape(-1, 2).tolist()}
    assert second.ami == len(want)
    assert second.predicted_edges == second.edges == \
        len(want) * 3 + 1200 - 300 * 2
    assert _removed(rows, [first, second], n_terms) == [
        e.baseline_edges - e.predicted_edges for e in (first, second)]
    gp, _ = fsp.factorize(rows, [first, second], n_terms, TYPE, INST)
    assert rows_diff(fsp.expand(gp, TYPE, INST), sort_unique(rows)) == 0


def test_efsp_scans_the_lattice_in_the_programs_order():
    rng = seeded_rng(5)
    rows, _ = _class_rows(rng, 300, [_one(3), _one(2), _one(50), _one(2),
                                     _optional(0.5, 2)])
    g = Graph(rows, TYPE)
    r = fsp.efsp(g, CLS, INST)
    n_s = 5
    assert r.iterations == n_s - 1
    assert r.evaluations == sum(len(list(itertools.combinations(
        range(n_s), k))) for k in range(2, n_s + 1))
    view = fsp.ClassView(g, CLS, g.class_properties(CLS, (INST,)))
    scores = [(view.score(c)[0], c) for k in range(n_s, 1, -1)
              for c in itertools.combinations(range(n_s), k)]
    best = min(s for s, _ in scores)
    first = next(c for s, c in scores if s == best)
    assert r.props == tuple(P0 + i for i in first)
    assert r.predicted_edges == best


def test_efsp_refuses_a_class_of_more_than_16_properties():
    rng = seeded_rng(1)
    rows, _ = _class_rows(rng, 50, [_one(2)] * 17)
    with pytest.raises(ValueError, match="17 properties"):
        fsp.efsp(Graph(rows, TYPE), CLS, INST)
