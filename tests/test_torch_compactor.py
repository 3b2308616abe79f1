"""The repro_torch pipeline against the JAX package end to end: every
detector x backend on the figure graphs, a sensor graph and every
workload shape, carried across with ``convert.store_from_arrays`` --
the same plan, per-class results, G' bytes and digest -- and the star
queries on G' giving the same bindings."""
import numpy as np
import pytest

from repro.api import Compactor as JCompactor
from repro.data import synthetic as jsyn
from repro.query import QueryEngine as JQueryEngine
from repro_torch.api import Compactor
from repro_torch.convert import store_from_arrays
from repro_torch.data import synthetic as tsyn
from repro_torch.query import QueryEngine, StarQuery, eval_raw

GRAPHS = ["figure1", "figure7a", "figure7b", "sensor3000",
          *[f"workload-{s}" for s in jsyn.WORKLOAD_SHAPES]]


def _build(mod, name):
    if name.startswith("figure"):
        return getattr(mod, f"{name}_graph")()
    if name == "sensor3000":
        return mod.generate(mod.SensorGraphSpec(n_observations=3000))
    shape = name.split("-", 1)[1]
    return mod.generate_workload(mod.WorkloadSpec(shape=shape,
                                                  n_triples=10_000, seed=0))


_REF: dict = {}


def _reference(name, detector):
    """(reference store, reference Compactor after run, its report)."""
    key = (name, detector)
    if key not in _REF:
        store = _build(jsyn, name)
        comp = JCompactor(detector, "host")
        _REF[key] = (store, comp, comp.run(store))
    return _REF[key]


def _plan_rows(report):
    return [(e.class_id, e.props, e.predicted_edges, e.baseline_edges,
             e.detection.props, e.detection.edges, e.detection.ami,
             e.detection.am, e.detection.evaluations,
             e.detection.iterations) for e in report.plan]


@pytest.mark.parametrize("name", GRAPHS)
def test_generators_are_byte_identical(name):
    ref = _build(jsyn, name)
    port = _build(tsyn, name)
    assert port.dict._terms == ref.dict._terms
    assert port.spo.dtype == ref.spo.dtype
    assert port.spo.tobytes() == ref.spo.tobytes()


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("detector", ["gfsp", "efsp"])
@pytest.mark.parametrize("name", GRAPHS)
def test_compaction_matches_reference(name, detector, backend):
    ref_store, ref_comp, ref = _reference(name, detector)
    store = store_from_arrays(list(ref_store.dict._terms), ref_store.spo)
    opts = {"device": "cpu"} if backend == "device" else {}
    comp = Compactor(detector, backend, backend_opts=opts)
    got = comp.run(store)
    assert _plan_rows(got) == _plan_rows(ref)
    for e, je in zip(got.plan, ref.plan):
        assert len(e.detection.fsp) == len(je.detection.fsp)
        for (m, o), (jm, jo) in zip(e.detection.fsp, je.detection.fsp):
            np.testing.assert_array_equal(m, jm)
            np.testing.assert_array_equal(o, jo)
    assert got.n_triples_before == ref.n_triples_before
    assert got.n_triples_after == ref.n_triples_after
    assert got.graph.spo.tobytes() == ref.graph.spo.tobytes()
    assert comp.snapshot.digest() == ref_comp.snapshot.digest()
    # lossless: G' expands back to the input graph
    assert comp.fgraph.expand().spo.tobytes() == store.spo.tobytes()
    comp.fgraph.validate()
    # the dictionary minted the same surrogate terms in the same order
    assert store.dict._terms == ref_store.dict._terms[:len(store.dict)]


def _queries(store, fg):
    """Star queries over the molecule tables: full ground tuples, a
    ground prefix with a variable arm, a ground arm outside SP, class
    scans, classless and missing lookups."""
    out = []
    for cid in [int(c) for c in store.classes()][:3]:
        out.append(StarQuery(arms=(), class_id=cid))
    for cid, t in sorted(fg.tables.items()):
        outside = [int(p) for p in store.class_properties(cid)
                   if int(p) not in t.props]
        for r in sorted({0, t.n_molecules // 2, t.n_molecules - 1}):
            row = [(p, int(o)) for p, o in zip(t.props, t.objects[r])]
            out.append(StarQuery(arms=tuple(row), class_id=cid))
            out.append(StarQuery(arms=tuple(row[:-1]) + ((t.props[-1], None),),
                                 class_id=cid))
            out.append(StarQuery(arms=(row[0],)))
            if outside:
                m = int(fg.members(int(t.surrogates[r]))[0])
                sl = store.index.pred_slice(outside[0])
                o = int(sl[np.searchsorted(sl[:, 0], m), 2])
                out.append(StarQuery(arms=(row[0], (outside[0], o)),
                                     class_id=cid))
                out.append(StarQuery(arms=(row[0], (outside[-1], None)),
                                     class_id=cid))
        out.append(StarQuery(arms=((t.props[0], 10**7),), class_id=cid))
    return out


@pytest.mark.parametrize("name", GRAPHS)
def test_star_queries_match_reference(name):
    ref_store, ref_comp, _ = _reference(name, "gfsp")
    store = store_from_arrays(list(ref_store.dict._terms), ref_store.spo)
    comp = Compactor("gfsp", "host")
    comp.run(store)
    queries = _queries(store, comp.fgraph)
    assert queries
    jeng = JQueryEngine(ref_comp.fgraph, use_kernel=False)
    eng = QueryEngine(comp.fgraph, device="cpu")
    batch = eng.query_batch(queries, backend="device")
    host = eng.query_batch(queries)
    for q, b, h in zip(queries, batch, host):
        want = jeng.query(q).canonical()
        for got in (b, h, eng.query(q, strategy="raw"), eval_raw(store, q)):
            c = got.canonical()
            assert c.shape == want.shape and (c == want).all(), q
