"""repro_torch's gSpan miner and the gSpan-counted detectors against the
JAX package's: the same patterns, supports, embeddings and order from
``mine``, the same minimal codes, molecules and pattern dictionaries, and
equal ``FSPResult``s for the ``gspan`` baseline and both legacy ``efsp``
entry points (``min_support > 1``, an explicit ``subgraphs_dict``)."""
import numpy as np
import pytest

from repro.api import Compactor as JCompactor
from repro.api import ExhaustiveDetector as JExhaustive
from repro.api import GSpanBaseline as JGSpan
from repro.core.efsp import build_subgraphs_dict as jbuild
from repro.core import gspan as jg
from repro.data import synthetic as jsyn
from repro_torch.api import Compactor, ExhaustiveDetector, GSpanBaseline
from repro_torch.core import build_subgraphs_dict
from repro_torch.core import gspan as tg
from repro_torch.data import synthetic as tsyn


# each case: (vertex labels, edges) per database graph, min_support,
# max_edges -- the hand graphs of tests/test_gspan.py and a few shapes
# that take the backward-edge and mixed-direction paths
HAND = {
    "single-edge": ([([0, 1], [(0, 1, 7)]), ([0, 1], [(0, 1, 7)])], 2, None),
    "star3": ([([10, 1, 2, 3], [(0, 1, 100), (0, 2, 101), (0, 3, 102)])],
              1, None),
    "support": ([([5, o], [(0, 1, 9)]) for o in (1, 1, 2)], 1, None),
    "support-min2": ([([5, o], [(0, 1, 9)]) for o in (1, 1, 2)], 2, None),
    "chain": ([([0, 1, 2], [(0, 1, 5), (1, 2, 6)])], 1, None),
    "triangle": ([([0, 0, 0], [(0, 1, 1), (1, 2, 1), (2, 0, 1)])], 1, None),
    "minimality": ([([1, 2, 3], [(0, 1, 4), (0, 2, 5)])], 1, None),
    "star4": ([([99, 1, 2, 3, 4], [(0, i + 1, 50 + i) for i in range(4)])],
              1, None),
    "star6": ([([99, 1, 2, 3, 4, 5, 6],
                [(0, i + 1, 50 + i) for i in range(6)])], 1, None),
    "square-mixed": ([([0, 1, 0, 1], [(0, 1, 3), (2, 1, 3), (2, 3, 4),
                                      (0, 3, 4)]),
                      ([0, 1, 0], [(0, 1, 3), (2, 1, 3)])], 1, None),
    "two-cycle-labels": ([([7, 7], [(0, 1, 2), (1, 0, 2)]),
                          ([7, 7, 7], [(0, 1, 2), (1, 2, 2), (2, 0, 2)])],
                         2, None),
    "star6-capped": ([([99, 1, 1, 2, 2, 3, 3],
                       [(0, i + 1, 50 + i % 3) for i in range(6)])], 1, 3),
}


def _graphs(mod, case):
    return [mod.DBGraph.from_edges(vl, es) for vl, es in case]


def _patterns(pats):
    """Patterns as plain data, in mined order: code, support and every
    embedding (graph id, vertex map, used edges)."""
    return [(p.code, p.support, p.n_edges,
             [(e.gid, e.vmap, sorted(e.used)) for e in p.embeddings])
            for p in pats]


def _graph_data(g):
    return (g.vlabels, g.adj, g.edges)


@pytest.mark.parametrize("name", sorted(HAND))
def test_mine_matches_reference(name):
    case, min_support, max_edges = HAND[name]
    got = tg.mine(_graphs(tg, case), min_support, max_edges)
    want = jg.mine(_graphs(jg, case), min_support, max_edges)
    assert got, name
    assert _patterns(got) == _patterns(want)


def test_hand_graph_counts():
    """The counts tests/test_gspan.py pins for the reference."""
    count = {n: len(tg.mine(_graphs(tg, HAND[n][0]), *HAND[n][1:]))
             for n in ("single-edge", "star3", "star4", "star6")}
    assert count == {"single-edge": 1, "star3": 7, "star4": 15, "star6": 63}
    assert any(len(p.code) == 3 for p in
               tg.mine(_graphs(tg, HAND["triangle"][0]), 1))


@pytest.mark.parametrize("name", sorted(HAND))
def test_is_min_and_min_code_match_reference(name):
    case, min_support, max_edges = HAND[name]
    for p in jg.mine(_graphs(jg, case), min_support, max_edges):
        assert tg.is_min(p.code) and jg.is_min(p.code)
        assert tg._min_code(tg._code_graph(p.code)) == p.code
        assert tg._rightmost_path(p.code) == jg._rightmost_path(p.code)
        # the same edges in another DFS order: not minimal on either side
        if len(p.code) >= 2:
            g = tg._code_graph(p.code)
            rev = tuple(reversed(p.code))
            assert tg.is_min(rev) == jg.is_min(rev)
            assert _graph_data(tg._code_graph(p.code)) == \
                _graph_data(jg._code_graph(p.code))
            assert tg._min_code(g) == jg._min_code(jg._code_graph(p.code))


def test_dfs_code_order_matches_reference():
    rng = np.random.default_rng(0)
    tuples = [tuple(int(x) for x in rng.integers(0, 4, 6)) for _ in range(300)]
    assert sorted(tuples, key=tg._tuple_key) == sorted(tuples,
                                                       key=jg._tuple_key)
    assert [tg._code_key(tuples[i:i + 3]) for i in range(0, 300, 3)] == \
        [jg._code_key(tuples[i:i + 3]) for i in range(0, 300, 3)]


def _stores(name):
    """(port store, reference store) from the two byte-identical
    generators."""
    if name == "figure1":
        return tsyn.figure1_graph(), jsyn.figure1_graph()
    spec = dict(n_observations=200, seed=42)
    return (tsyn.generate(tsyn.SensorGraphSpec(**spec)),
            jsyn.generate(jsyn.SensorGraphSpec(**spec)))


_STORES: dict = {}


def _cached_stores(name):
    if name not in _STORES:
        t, j = _stores(name)
        assert t.spo.tobytes() == j.spo.tobytes()
        _STORES[name] = (t, j)
    return _STORES[name]


def _classes(store):
    return [int(c) for c in store.classes()
            if store.class_stats(int(c)).properties.shape[0] >= 2]


@pytest.mark.parametrize("name", ["figure1", "sensor200"])
def test_molecules_of_class_matches_reference(name):
    t, j = _cached_stores(name)
    for cid in [int(c) for c in t.classes()]:
        ents, graphs = tg.molecules_of_class(t, cid)
        jents, jgraphs = jg.molecules_of_class(j, cid)
        np.testing.assert_array_equal(ents, jents)
        assert [_graph_data(g) for g in graphs] == \
            [_graph_data(g) for g in jgraphs]
    if name == "figure1":
        C = t.dict.lookup("C")
        _, graphs = tg.molecules_of_class(t, C)
        assert len(graphs) == 4
        assert all(len(g.edges) == 4 and g.vlabels[0] == C for g in graphs)


@pytest.mark.parametrize("min_support", [1, 2])
@pytest.mark.parametrize("name", ["figure1", "sensor200"])
def test_build_subgraphs_dict_matches_reference(name, min_support):
    t, j = _cached_stores(name)
    for cid in _classes(t):
        sd, n_pat, ents = build_subgraphs_dict(t, cid, min_support)
        jsd, jn_pat, jents = jbuild(j, cid, min_support)
        assert sd == jsd and n_pat == jn_pat
        assert list(sd) == list(jsd)            # first-seen order too
        np.testing.assert_array_equal(ents, jents)


def _fields(r):
    fsp = [(m.tolist(), o.tolist()) for m, o in r.fsp]
    return (r.class_id, r.props, r.edges, r.ami, r.am, r.iterations,
            r.evaluations, fsp)


def _detectors():
    """(label, port detector, reference detector); ``efsp-sd`` is handed
    an explicit subgraphs_dict per class."""
    return [("gspan", GSpanBaseline(), JGSpan()),
            ("gspan-min2", GSpanBaseline(min_support=2),
             JGSpan(min_support=2)),
            ("gspan-max2", GSpanBaseline(max_edges=2), JGSpan(max_edges=2)),
            ("gspan-nothing-mined", GSpanBaseline(min_support=10 ** 6),
             JGSpan(min_support=10 ** 6)),
            ("efsp-min2", ExhaustiveDetector(min_support=2),
             JExhaustive(min_support=2)),
            ("efsp-sd", ExhaustiveDetector(), JExhaustive())]


@pytest.mark.parametrize("label", [d[0] for d in _detectors()])
@pytest.mark.parametrize("name", ["figure1", "sensor200"])
def test_gspan_counted_detectors_match_reference(name, label):
    t, j = _cached_stores(name)
    _, det, jdet = next(d for d in _detectors() if d[0] == label)
    for cid in _classes(t):
        if label == "efsp-sd":
            sd = build_subgraphs_dict(t, cid)[0]
            got = det.detect(t, cid, subgraphs_dict=sd)
            want = jdet.detect(j, cid,
                               subgraphs_dict=jbuild(
                                   j, cid)[0])
        else:
            got, want = det.detect(t, cid), jdet.detect(j, cid)
        assert _fields(got) == _fields(want), (label, cid)
        if label == "gspan-nothing-mined":
            assert got.evaluations == 1 and len(got.props) >= 2


@pytest.mark.parametrize("name", ["figure1", "sensor200"])
def test_gspan_compactor_matches_reference_and_gfsp(name):
    """Through the Compactor: the gspan baseline and the legacy efsp give
    the reference's plans and digests, and gspan's SP and edges equal
    gfsp's on the device backend (complete molecules)."""
    t, j = _cached_stores(name)
    rows = lambda rep: [(e.class_id, e.props, e.predicted_edges,  # noqa: E731
                         e.detection.ami, e.detection.evaluations,
                         e.detection.iterations) for e in rep.plan]
    for det, opts in (("gspan", {}), ("efsp", {"min_support": 2})):
        comp = Compactor(det, "device", detector_opts=opts,
                         backend_opts={"device": "cpu"})
        jcomp = JCompactor(det, "host", detector_opts=opts)
        got, want = comp.run(t), jcomp.run(j)
        assert rows(got) == rows(want)
        assert got.graph.spo.tobytes() == want.graph.spo.tobytes()
        assert comp.snapshot.digest() == jcomp.snapshot.digest()
    gs = Compactor("gspan").plan(t)
    gf = Compactor("gfsp", "device", backend_opts={"device": "cpu"}).plan(t)
    assert [(e.class_id, e.props, e.detection.edges) for e in gs] == \
        [(e.class_id, e.props, e.detection.edges) for e in gf]
    assert gs.entries
