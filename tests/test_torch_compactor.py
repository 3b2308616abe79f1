"""The repro_torch pipeline against the JAX package end to end: every
detector x backend on the figure graphs, a sensor graph and every
workload shape, carried across with ``convert.store_from_arrays`` --
the same plan, per-class results, G' bytes and digest -- and the star
queries on G' giving the same bindings."""

import numpy as np
import pytest

from repro.api import Compactor as JCompactor
from repro.core.triples import TermDict as JTermDict
from repro.data import synthetic as jsyn
from repro.query import QueryEngine as JQueryEngine
from repro_torch.api import Compactor
from repro_torch.convert import store_from_arrays
from repro_torch.core import index
from repro_torch.core.triples import TermDict
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


class _PaddedTerms:
    """A term list with ``n`` filler terms, made on demand, at ids
    ``[at, at + n)``, and ``stride - 1`` after each term past them: the
    id i >= ``at`` of a term moves to ``at + n + (i - at) * stride``
    without a list of that length.  Terms added later follow on."""

    def __init__(self, terms, at, n, stride=1):
        self._head, self._tail = list(terms[:at]), list(terms[at:])
        self._at, self._n, self._stride = at, n, stride
        self._spread = len(self._tail)

    def __len__(self):
        return (self._at + self._n + len(self._tail)
                + self._spread * (self._stride - 1))

    def __getitem__(self, i):
        if i < self._at:
            return self._head[i]
        d = i - self._at - self._n
        if d < 0:
            return f"pad/{i}"
        if d < self._spread * self._stride:
            q, r = divmod(d, self._stride)
            return f"pad/{i}" if r else self._tail[q]
        return self._tail[d - self._spread * (self._stride - 1)]

    def extend(self, terms):
        self._tail.extend(terms)

    def append(self, term):
        self._tail.append(term)


def _padded_store(term_dict, store, pad, stride=1, schema_too=False):
    """``store`` with every id past the predicates and classes (with
    ``schema_too``, past ``rdf:type`` and ``repro:instanceOf``) moved up
    by ``pad`` and spread ``stride`` apart (order kept), over a
    dictionary of the same terms."""
    spo = store.spo
    at = max(store.TYPE, store.INSTANCE_OF) + 1 if schema_too else int(
        max(spo[:, 1].max(), spo[spo[:, 1] == store.TYPE, 2].max())) + 1
    terms = store.dict._terms
    d = term_dict()
    d._terms = _PaddedTerms(terms, at, pad, stride)
    d._index = {t: i if i < at else at + pad + (i - at) * stride
                for i, t in enumerate(terms)}
    wide = spo.astype(np.int64)
    spo = np.where(wide < at, wide, at + pad + (wide - at) * stride)
    assert spo.max() < 2**31
    return type(store).from_ids(d, spo.astype(np.int32)), d


def _compact_padded(pad, stride=1, schema_too=False):
    """One gfsp/device compaction of a sensor graph under
    :func:`_padded_store` against the JAX package's, checked for the
    same plan, G' rows, digest, expansion and minted terms; returns the
    store."""
    spec = dict(n_observations=600, seed=11)
    ref_store, ref_dict = _padded_store(
        JTermDict, jsyn.generate(jsyn.SensorGraphSpec(**spec)), pad, stride,
        schema_too)
    store, tdict = _padded_store(
        TermDict, tsyn.generate(tsyn.SensorGraphSpec(**spec)), pad, stride,
        schema_too)
    assert store.spo.tobytes() == ref_store.spo.tobytes()
    ref_comp = JCompactor("gfsp", "host")
    ref = ref_comp.run(ref_store)
    comp = Compactor("gfsp", "device", backend_opts={"device": "cpu"})
    got = comp.run(store)
    assert _plan_rows(got) == _plan_rows(ref)
    assert got.graph.spo.tobytes() == ref.graph.spo.tobytes()
    assert comp.snapshot.digest() == ref_comp.snapshot.digest()
    assert comp.fgraph.expand().spo.tobytes() == store.spo.tobytes()
    assert len(tdict) == len(ref_dict)
    assert tdict._terms._tail == ref_dict._terms._tail
    return store


def _key_kind(cols, rows):
    """The kind of key ``index.row_keys`` builds over ``rows``: one
    int64 per row, or the structured view of the row."""
    (key,) = index.row_keys(cols, rows)
    return "packed" if key.dtype == np.int64 else "void"


# subject and object ids of 22 bits pack with the predicates' into one
# int64; of 31 bits they cannot, as the subjects and objects also hold
# the schema's small ids, so both columns' ranges take 31 bits and every
# triple key is the structured view
@pytest.mark.parametrize("pad,kind", [(2**21, "packed"), (2**30, "void")])
def test_compaction_with_wide_ids_matches_reference(pad, kind):
    store = _compact_padded(pad)
    assert int(store.spo[:, 0].max()).bit_length() >= 22
    assert {_key_kind(perm, store.spo)
            for perm in (index.SPO_PERM, index.PSO_PERM)} == {kind}


def _largest_class_matrix(store):
    """The object matrix over all of S of the class with the most
    properties."""
    stats = max((store.class_stats(c) for c in store.classes()),
                key=lambda st: st.properties.shape[0])
    return store.object_matrix(stats.class_id, stats.properties)[1]


# every id past rdf:type and instanceOf moved up by 2**21: the
# Observation class's five columns take 22 bits each from 0, so they
# pack only from each column's minimum; spread 2**16 apart, their
# ranges need more than 63 bits, and the compaction runs on the
# structured view
@pytest.mark.parametrize("pad,stride,kinds", [
    (2**21, 1, {"packed"}), (0, 2**16, {"void"})],
    ids=["offsets", "void"])
def test_compaction_groups_object_rows_as_the_reference(pad, stride, kinds):
    store = _compact_padded(pad, stride, schema_too=True)
    mat = _largest_class_matrix(store)
    assert {_key_kind(index.SPO_PERM, store.spo),
            _key_kind(range(mat.shape[1]), mat)} == kinds
    from_zero = sum(int(c.max()).bit_length() for c in mat.T)
    from_min = sum(int(c.max() - c.min()).bit_length() for c in mat.T)
    assert mat.shape[1] == 5 and mat.min() >= pad and from_zero > 63
    assert (from_min <= 63) == ("void" not in kinds)
