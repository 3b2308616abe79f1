"""The factorization's size accounting against the JAX package: the
labeled-edge and node counts of each class before and after (paper
Table 5 and Fig. 9), their savings and the triple counts, class after
class through ``factorize_classes``, on stores whose ids are dense and
on stores whose ids are sparse against the rows, with each of the two
ways of counting, and which way the ``count`` span says it took."""
import pytest

from repro.core.factorize import factorize_classes as jfactorize_classes
from repro.core.triples import TermDict as JTermDict
from repro.core.triples import TripleStore as JTripleStore
from repro.data import synthetic as jsyn
from repro_torch import obs
from repro_torch.core import factorize
from repro_torch.core.triples import TermDict, TripleStore
from repro_torch.data import synthetic as tsyn
from test_torch_compactor import _padded_store

SENSOR = dict(n_observations=600, seed=11)

# an entity of both C and D, entities of one class only, and a class
# (ex:E) that is named as an object but has no entities
TYPED_TWICE = [
    ("ex:e1", "rdf:type", "ex:C"), ("ex:e1", "rdf:type", "ex:D"),
    ("ex:e1", "ex:p", "ex:a"), ("ex:e1", "ex:q", "ex:x"),
    ("ex:e2", "rdf:type", "ex:C"), ("ex:e2", "ex:p", "ex:a"),
    ("ex:e2", "ex:q", "ex:y"),
    ("ex:e3", "rdf:type", "ex:D"), ("ex:e3", "ex:q", "ex:x"),
    ("ex:e3", "ex:r", "ex:e1"),
    ("ex:e4", "rdf:type", "ex:C"), ("ex:e4", "ex:p", "ex:b"),
    ("ex:e5", "ex:s", "ex:E"),
]


def _sensor(syn, sids, **spec):
    store = syn.generate(syn.SensorGraphSpec(**{**SENSOR, **spec}))
    return store, [syn.property_set_ids(store, sid) for sid in sids]


def _terms(store_cls, plans):
    store = store_cls.from_triples(TYPED_TWICE)
    ids = store.dict.lookup
    return store, [(ids(c), [ids(p) for p in ps]) for c, ps in plans]


def _empty(store_cls):
    store = store_cls()
    return store, [(store.dict.id("ex:C"), [store.dict.id("ex:p")])]


def _padded(syn, term_dict, pad):
    store, _ = _padded_store(term_dict, syn.generate(
        syn.SensorGraphSpec(**SENSOR)), pad)
    return store, [syn.property_set_ids(store, sid) for sid in ("A4", "A8")]


# name -> (JAX store and plans, the port's); the plans run in order, so
# a later class counts the earlier ones' instanceOf subjects
STORES = {
    "sensor": lambda m: _sensor(m, ("A4", "A8")),
    "sensor-measurement-first": lambda m: _sensor(m, ("A9", "A3")),
    "sensor-with-stations": lambda m: _sensor(
        m, ("A5", "A8"), include_sensor_metadata=True),
    "typed-twice": lambda m: _terms(
        JTripleStore if m is jsyn else TripleStore,
        [("ex:C", ["ex:p"]), ("ex:D", ["ex:q"])]),
    "class-without-entities": lambda m: _terms(
        JTripleStore if m is jsyn else TripleStore,
        [("ex:E", ["ex:s"]), ("ex:C", ["ex:p"])]),
    "empty-graph": lambda m: _empty(
        JTripleStore if m is jsyn else TripleStore),
    "pad-2**21": lambda m: _padded(
        m, JTermDict if m is jsyn else TermDict, 2**21),
    "pad-2**30": lambda m: _padded(
        m, JTermDict if m is jsyn else TermDict, 2**30),
}

# how the port counts: as its rule chooses, or held to one way (a
# threshold of 0 ids a row admits no bitmap, one of 2**31 every
# non-empty store's); a bitmap over ids near 2**30 would take a GiB
WAYS = {"chosen": None, "sorted": 0, "dense": 2**31}
CASES = [(name, way) for name in STORES for way in WAYS
         if (name, way) != ("pad-2**30", "dense")]


def _fields(res):
    return (res.class_id, res.props, res.n_triples_before,
            res.n_triples_after, res.nle_before, res.nle_after,
            res.nn_before, res.nn_after, res.pct_savings_nle,
            res.pct_savings_size, res.pct_savings_triples)


@pytest.mark.parametrize("name,way", CASES)
def test_counts_match_reference(name, way, monkeypatch):
    ref_store, ref_plans = STORES[name](jsyn)
    store, plans = STORES[name](tsyn)
    assert plans == ref_plans
    assert store.spo.tobytes() == ref_store.spo.tobytes()
    if WAYS[way] is not None:
        monkeypatch.setattr(factorize, "_DENSE_IDS_PER_ROW", WAYS[way])
    ref_g, ref = jfactorize_classes(ref_store, ref_plans)
    g, got = factorize.factorize_classes(store, plans)
    assert [_fields(r) for r in got] == [_fields(r) for r in ref]
    assert g.spo.tobytes() == ref_g.spo.tobytes()


@pytest.mark.parametrize("name,way", [("sensor", "dense"),
                                      ("sensor-with-stations", "dense"),
                                      ("typed-twice", "dense"),
                                      ("pad-2**21", "sorted"),
                                      ("pad-2**30", "sorted"),
                                      ("empty-graph", "sorted")])
def test_count_span_names_the_way(name, way):
    store, plans = STORES[name](tsyn)
    obs.clear()
    obs.enable()
    try:
        factorize.factorize_classes(store, plans)
    finally:
        obs.disable()
    counts = [r.attrs for r in obs.records() if r.name == "count"]
    obs.clear()
    assert counts == [{"ids": way}] * (2 * len(plans))


def test_dense_count_reads_the_index_of_a_compressed_store():
    store, plans = STORES["sensor"](tsyn)
    _, want = factorize.factorize_classes(store, plans)
    _, got = factorize.factorize_classes(store.compressed(), plans)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert all(r.nle_before > 0 for r in got)
