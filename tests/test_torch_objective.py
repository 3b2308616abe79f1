"""The port's default objective against the benchmark's plain reference.

``Compactor("efsp"|"gfsp", backend)`` scores a star pattern on the
entities it folds and folds an entity typed twice once
(``core.star.folded_edges``, ``CompactionPlanner._fold_once``);
``bench_port/ref/fsp.py`` states the same semantics in plain numpy and
shares no code with the port.  Every store here has multi-valued,
optional or never complete properties, or entities typed twice: the plan
fields, G' rows, molecule tables and the lossless expansion must equal
the reference's on both backends.  ``objective="complete"`` keeps the
JAX package's scoring, and on a functional store both objectives plan
alike.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.gen import lubm  # noqa: E402
from bench_port.gen.sensor import seeded_rng  # noqa: E402
from bench_port.ref import fsp  # noqa: E402
from bench_port.ref.graph import Graph, rows_diff, sort_unique  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.api import Compactor  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The device path's plain CPU kernels launch many small ops: one
    thread each keeps them from contending with the other test workers
    (E.FSP on LUBM(1) takes seconds so, minutes oversubscribed)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DETECTORS = ("efsp", "gfsp")
BACKENDS = ("host", "device")

# the hand-built schema: Student (major, year functional; takes 1-3
# objects; advisor on one in three; alias always twice: never complete),
# Worker (site, dept, major; half of them students too), Tutor (major,
# year; every tutor a student), Course (dept, level: complete and
# functional) and Visitor (site on seven in ten, dept, a unique badge:
# its best SP, {site, dept}, folds only the visitors with a site)
CLASSES = ("Student", "Worker", "Tutor", "Course", "Visitor")
PREDS = ("major", "year", "takes", "advisor", "alias", "site", "dept",
         "level", "badge")
VALUES = 40


def _hand_store(seed: int) -> tuple[list[str], np.ndarray]:
    rng = np.random.default_rng(seed)
    terms = ["rdf:type", "repro:instanceOf", *CLASSES, *PREDS]
    tid = {t: i for i, t in enumerate(terms)}
    vals = len(terms) + np.arange(VALUES)
    terms += [f"v/{i}" for i in range(VALUES)]
    n_stu, n_work, n_course = 160, 90, 60
    stu = len(terms) + np.arange(n_stu)
    terms += [f"student/{i}" for i in range(n_stu)]
    only_work = len(terms) + np.arange(n_work // 2)
    terms += [f"worker/{i}" for i in range(n_work // 2)]
    course = len(terms) + np.arange(n_course)
    terms += [f"course/{i}" for i in range(n_course)]
    visitor = len(terms) + np.arange(100)
    terms += [f"visitor/{i}" for i in range(100)]
    badge = len(terms) + np.arange(100)
    terms += [f"badge/{i}" for i in range(100)]
    work = np.concatenate([stu[:n_work - n_work // 2], only_work])
    tutor = stu[-30:]
    rows = []

    def arm(s, p, o):
        rows.append(np.stack([s, np.full(len(s), tid[p]), o], 1))

    def draw(ents, p, hi):
        arm(ents, p, vals[rng.integers(0, hi, len(ents))])

    for ents, cls in ((stu, "Student"), (work, "Worker"), (tutor, "Tutor"),
                      (course, "Course"), (visitor, "Visitor")):
        arm(ents, "rdf:type", np.full(len(ents), tid[cls]))
    draw(np.concatenate([stu, only_work]), "major", 4)
    draw(stu, "year", 3)
    takes = np.repeat(stu, rng.integers(1, 4, n_stu))
    draw(takes, "takes", 6)
    draw(stu[rng.random(n_stu) < 1 / 3], "advisor", 5)
    arm(np.repeat(stu, 2), "alias", np.tile(vals[:2], n_stu))
    draw(work, "site", 3)
    draw(np.concatenate([work, course]), "dept", 3)
    draw(course, "level", 2)
    draw(visitor[rng.random(100) < 0.7], "site", 2)
    draw(visitor, "dept", 3)
    arm(visitor, "badge", badge)
    return terms, np.concatenate(rows).astype(np.int32)


def _lubm_store(seed: int) -> tuple[list[str], np.ndarray]:
    spec = lubm.LubmSpec(1)
    vocab = lubm.Vocabulary(spec)
    return vocab.terms, lubm.graph_rows(vocab, spec, seeded_rng(seed))


STORES = {"hand-1": lambda: _hand_store(1), "hand-2": lambda: _hand_store(2),
          "lubm1-7": lambda: _lubm_store(7),
          "lubm1-2147483901": lambda: _lubm_store(2**31 + 253)}
_MADE: dict = {}


def _store(name):
    if name not in _MADE:
        _MADE[name] = STORES[name]()
    return _MADE[name]


_REF: dict = {}


def _reference(name, detector):
    """(plan rows, G' rows, tables) as ``ref/fsp.py`` works them out."""
    key = (name, detector)
    if key not in _REF:
        terms, spo = _store(name)
        entries = fsp.plan(Graph(spo, 0), inst_id=1, detector=detector)
        gp, tables = fsp.factorize(spo, entries, len(terms), 0, 1)
        rows = [(e.class_id, e.props, e.edges, e.ami, e.evaluations,
                 e.iterations, e.predicted_edges, e.baseline_edges)
                for e in entries]
        _REF[key] = rows, gp, {c: (t.props, t.surrogates, t.objects)
                               for c, t in tables.items()}
    return _REF[key]


def _port(terms, spo, detector, backend, **opts):
    comp = Compactor(detector, backend,
                     backend_opts={"device": "cpu"}
                     if backend == "device" else None, **opts)
    store = store_from_arrays(terms, spo)
    plan = comp.plan(store)
    rep = comp.execute(store, plan)
    rows = [(e.class_id, tuple(e.props), e.detection.edges, e.detection.ami,
             e.detection.evaluations, e.detection.iterations,
             e.predicted_edges, e.baseline_edges) for e in rep.plan]
    tables = {c: (t.props, t.surrogates, t.objects)
              for c, t in rep.fgraph.tables.items()}
    return rows, rep.graph.spo, tables, rep


def _same_tables(got, want):
    assert set(got) == set(want)
    for cid, (props, sg, objs) in want.items():
        g_props, g_sg, g_objs = got[cid]
        assert tuple(g_props) == tuple(props)
        assert np.array_equal(np.asarray(g_sg, np.int64), sg)
        assert np.array_equal(np.asarray(g_objs, np.int64), objs)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("detector", DETECTORS)
@pytest.mark.parametrize("name", list(STORES))
def test_the_port_plans_and_compacts_as_the_reference(name, detector,
                                                      backend):
    terms, spo = _store(name)
    want_rows, want_gp, want_tables = _reference(name, detector)
    rows, gp, tables, _ = _port(terms, spo, detector, backend)
    assert rows == want_rows
    assert rows_diff(sort_unique(gp), want_gp) == 0
    _same_tables(tables, want_tables)
    assert rows_diff(fsp.expand(gp, 0, 1), sort_unique(spo)) == 0


@pytest.mark.parametrize("detector", DETECTORS)
def test_the_mesh_workspace_scores_as_the_reference(detector):
    """The sharded backend on a (2, 2) mesh of CPU entries: the sentinel
    rows cross the hash-bucket exchange like any other row."""
    from repro_torch.dist.mesh import make_mesh
    terms, spo = _store("hand-2")
    comp = Compactor(detector, "sharded", backend_opts={
        "mesh": make_mesh((2, 2), ("data", "model"), "cpu")})
    store = store_from_arrays(terms, spo)
    rep = comp.execute(store, comp.plan(store))
    rows = [(e.class_id, tuple(e.props), e.detection.edges, e.detection.ami,
             e.detection.evaluations, e.detection.iterations,
             e.predicted_edges, e.baseline_edges) for e in rep.plan]
    want_rows, want_gp, _ = _reference("hand-2", detector)
    assert rows == want_rows
    assert rows_diff(sort_unique(rep.graph.spo), want_gp) == 0


@pytest.mark.parametrize("name", ["hand-1", "lubm1-7"])
def test_a_class_folded_before_is_rescored_or_dropped(name):
    """Two classes share entities and a property of their SPs: the later
    one is rescored on the entities left (hand store: Tutor, all of them
    students, is dropped; LUBM: TeachingAssistant and ResearchAssistant,
    typed on graduates, are)."""
    terms, spo = _store(name)
    obs.enable()
    obs.clear()
    try:
        _port(terms, spo, "efsp", "host")
        recs = obs.records()
    finally:
        obs.disable()
        obs.clear()
    (fold,) = [r for r in recs if r.name == "fold"]
    assert fold.attrs["rescored"] >= 1 and fold.attrs["dropped"] >= 1
    # the pass reads the detections' star groups: it extracts nothing
    assert not any(r.name == "extract" and r.parent_id == fold.span_id
                   for r in recs)
    planned = {row[0] for row in _reference(name, "efsp")[0]}
    dropped = {terms.index(c) for c in ("Tutor", "ub:TeachingAssistant",
                                        "ub:ResearchAssistant")
               if c in terms}
    assert dropped and not dropped & planned


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["hand-1", "lubm1-7"])
def test_incomplete_entities_are_scored_not_skipped(name, backend):
    """Every planned class's predicted savings are the rows its
    factorization removes, so G' shrinks by their sum exactly."""
    terms, spo = _store(name)
    _, gp, _, rep = _port(terms, spo, "efsp", backend)
    saved = sum(e.predicted_savings for e in rep.plan)
    assert saved > 0
    assert sort_unique(spo).shape[0] - gp.shape[0] == saved


def test_the_complete_objective_is_the_jax_packages():
    """``objective="complete"`` scores Def. 4.8 over the entities complete
    over S, with no fold-once rule, as ``repro`` does on the same store."""
    pytest.importorskip("jax")
    from repro.api import Compactor as JCompactor
    from repro.core.triples import TermDict as JTermDict
    from repro.core.triples import TripleStore as JTripleStore
    terms, spo = _store("hand-1")
    for detector in DETECTORS:
        ref = JCompactor(detector, "host").run(
            JTripleStore.from_ids(JTermDict.from_terms(terms), spo))
        for backend in BACKENDS:
            _, gp, _, rep = _port(terms, spo, detector, backend,
                                  detector_opts={"objective": "complete"})
            assert [(e.class_id, e.props, e.predicted_edges,
                     e.baseline_edges) for e in rep.plan] == \
                [(e.class_id, e.props, e.predicted_edges, e.baseline_edges)
                 for e in ref.plan]
            assert gp.tobytes() == ref.graph.spo.tobytes()
        # and the default differs from it on this store
        rows, _, _, _ = _port(terms, spo, detector, "host")
        assert rows != [(e.class_id, e.props, e.detection.edges,
                         e.detection.ami, e.detection.evaluations,
                         e.detection.iterations, e.predicted_edges,
                         e.baseline_edges) for e in ref.plan]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("detector", DETECTORS)
def test_a_functional_store_plans_alike_under_both_objectives(detector,
                                                              backend):
    """On the sensor graph (every property functional and complete) the
    folded objective is Def. 4.8 term for term: the same plan, the same
    G' digest."""
    from repro_torch.data import synthetic
    store = synthetic.generate(synthetic.SensorGraphSpec(n_observations=400))
    opts = {"device": "cpu"} if backend == "device" else None
    got = {}
    for objective in ("folded", "complete"):
        comp = Compactor(detector, backend, backend_opts=opts,
                         detector_opts={"objective": objective})
        rep = comp.run(store)
        got[objective] = ([(e.class_id, e.props, e.predicted_edges,
                            e.baseline_edges, e.detection.ami,
                            e.detection.evaluations,
                            e.detection.iterations) for e in rep.plan],
                          comp.snapshot.digest())
    assert got["folded"] == got["complete"]
    assert got["folded"][0]


def test_an_unknown_objective_is_refused():
    with pytest.raises(ValueError, match="objective"):
        Compactor("gfsp", detector_opts={"objective": "approximate"})
