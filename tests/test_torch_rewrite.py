"""G' by splicing a class's rows (``core/factorize.py`` ``_splice``)
against the rewrite it stands in for -- every row mapped by
``apply_molecule_map``, then sorted and deduplicated -- class after
class, and against the JAX package's ``factorize_classes``: the rows,
the snapshot digests and each class's counts.  Stores: sensor data,
LUBM(1) and a hand-built schema with multi-valued, optional and doubly
typed properties planned by the port's E.FSP, stores whose ``rdf:type``
and ``repro:instanceOf`` ids are neither 0 nor 1, entities that already
point to an earlier class's molecule, an empty class and a class of one
entity.  The ``rewrite`` span says which way each class took; a
redetect re-mints surrogate names that exist and takes the sort."""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.gen import lubm  # noqa: E402
from bench_port.gen.sensor import seeded_rng  # noqa: E402
from repro.api import Compactor as JCompactor  # noqa: E402
from repro.api import GraphSnapshot as JGraphSnapshot  # noqa: E402
from repro.core.factorize import factorize_classes as jfactorize_classes  # noqa: E402,E501
from repro.core.fgraph import FactorizedGraph as JFactorizedGraph  # noqa: E402,E501
from repro.core.triples import TermDict as JTermDict  # noqa: E402
from repro.core.triples import TripleStore as JTripleStore  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.api import Compactor, GraphSnapshot  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core import factorize  # noqa: E402
from repro_torch.core.fgraph import FactorizedGraph  # noqa: E402
from repro_torch.core.index import sort_unique  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from test_torch_objective import _hand_store  # noqa: E402


def _from_triples(triples):
    terms = list(dict.fromkeys(t for row in triples for t in row))
    tid = {t: i for i, t in enumerate(terms)}
    return terms, np.asarray([[tid[t] for t in row] for row in triples],
                             np.int32)


def _named(terms, plans):
    tid = {t: i for i, t in enumerate(terms)}
    return [(tid[c], [tid[p] for p in ps]) for c, ps in plans]


def _sensor(n, seed):
    store = tsyn.generate(tsyn.SensorGraphSpec(n_observations=n, seed=seed))
    return (list(store.dict._terms), store.spo,
            [tsyn.property_set_ids(store, sid) for sid in ("A4", "A8")])


def _efsp(terms, spo):
    store = store_from_arrays(terms, spo)
    plan = Compactor("efsp", "host").plan(store)
    return terms, spo, [(e.class_id, list(e.props)) for e in plan]


def _lubm(seed):
    spec = lubm.LubmSpec(1)
    vocab = lubm.Vocabulary(spec)
    return _efsp(vocab.terms, lubm.graph_rows(vocab, spec, seeded_rng(seed)))


def _hand_folded(seed):
    """The hand-built schema with its SPs named: Student over a
    functional, a multi-valued (``takes``) and an optional (``advisor``)
    property, so it folds the students with one course and an advisor;
    then Tutor, all of them students typed twice, and Worker."""
    terms, spo = _hand_store(seed)
    return terms, spo, _named(terms, [
        ("Student", ["major", "takes", "advisor"]),
        ("Tutor", ["major", "year"]), ("Worker", ["site", "dept"])])


def _scattered(seed):
    """Random rows over a dictionary in shuffled order: ``rdf:type`` and
    ``repro:instanceOf`` at any ids (instanceOf below or above type),
    SP predicates on both sides of instanceOf, subjects of other
    classes and of none above, below and between the class's entities,
    entities missing an SP property or holding it twice, and entities
    that already point to a molecule."""
    rng = np.random.default_rng(seed)
    words = (["rdf:type", "repro:instanceOf", "ex:C", "ex:D"]
             + [f"ex:p{i}" for i in range(8)]
             + [f"ex:e{i}" for i in range(60)]
             + [f"ex:v{i}" for i in range(6)]
             + [f"ex:old{i}" for i in range(3)])
    terms = [words[i] for i in rng.permutation(len(words))
             if words[i] != "repro:instanceOf"]
    # instanceOf between the predicates: four of them below it
    fourth = [i for i, t in enumerate(terms) if t.startswith("ex:p")][3]
    terms.insert(fourth + 1, "repro:instanceOf")
    triples = []
    for i in range(60):
        e = f"ex:e{i}"
        kind = rng.integers(0, 4)
        if kind < 3:
            triples.append((e, "rdf:type", "ex:C"))
        if kind > 0 and rng.random() < 0.5:
            triples.append((e, "rdf:type", "ex:D"))
        for j in range(8):
            for _ in range(int(rng.choice([0, 1, 1, 1, 1, 2]))):
                triples.append((e, f"ex:p{j}", f"ex:v{rng.integers(0, 3)}"))
        if rng.random() < 0.3:
            triples.append((e, "repro:instanceOf",
                            f"ex:old{rng.integers(0, 3)}"))
        if rng.random() < 0.3:
            triples.append((e, "ex:p7", f"ex:e{rng.integers(0, 60)}"))
    tid = {t: i for i, t in enumerate(terms)}
    spo = np.asarray([[tid[t] for t in row] for row in triples], np.int32)
    # SP: two predicates below instanceOf and one above, or the reverse
    by_id = sorted((f"ex:p{j}" for j in range(8)), key=terms.index)
    sp = [*rng.choice(by_id[:4], 2, replace=False),
          *rng.choice(by_id[4:], 1)]
    if seed % 2:
        sp = [*rng.choice(by_id[:4], 1), *rng.choice(by_id[4:], 2,
                                                       replace=False)]
    return terms, spo, _named(terms, [("ex:C", sp), ("ex:D", sp[:2])])


def _overlap():
    """``tests/test_api.py``'s overlapping classes: e0..e2 are A and B,
    e3 and e4 B alone; B's entities from A hold an instanceOf row when
    B is factorized."""
    triples = []
    for i in range(5):
        e = f"e{i}"
        if i < 3:
            triples += [(e, "rdf:type", "A"), (e, "p1", "x"), (e, "p2", "y")]
        triples += [(e, "rdf:type", "B"), (e, "q1", "v"), (e, "q2", "w")]
    terms, spo = _from_triples(triples)
    return terms, spo, _named(terms, [("A", ["p1", "p2"]),
                                      ("B", ["q1", "q2"])])


def _small_classes():
    """A class named only as an object (no entities), a class of one
    entity, and a class whose entities all lack an SP property."""
    terms, spo = _from_triples([
        ("ex:a", "rdf:type", "ex:One"), ("ex:a", "ex:p", "ex:x"),
        ("ex:a", "ex:q", "ex:y"), ("ex:a", "ex:r", "ex:E"),
        ("ex:b", "rdf:type", "ex:Two"), ("ex:b", "ex:p", "ex:x"),
        ("ex:c", "rdf:type", "ex:Two"), ("ex:c", "ex:p", "ex:z")])
    return terms, spo, _named(terms, [("ex:E", ["ex:p"]),
                                      ("ex:One", ["ex:p", "ex:q"]),
                                      ("ex:Two", ["ex:p", "ex:q"])])


def _instance_of_in_sp():
    """The overlapping classes with ``repro:instanceOf`` in B's SP: B
    folds the entities A folded, each moving its pointer to A's
    molecule onto B's."""
    terms, spo, plans = _overlap()
    terms = [*terms, "repro:instanceOf"]
    return terms, spo, [plans[0], (plans[1][0], [plans[1][1][0],
                                                 len(terms) - 1])]


STORES = {
    "lsd-600": lambda: _sensor(600, 11),
    "lsd-2000": lambda: _sensor(2000, 2**31 + 17),
    "lubm1-efsp": lambda: _lubm(7),
    "hand-efsp": lambda: _efsp(*_hand_store(1)),
    "hand-folded": lambda: _hand_folded(2),
    "scattered-0": lambda: _scattered(0),
    "scattered-1": lambda: _scattered(1),
    "scattered-2": lambda: _scattered(2),
    "overlap": _overlap,
    "instance-of-in-sp": _instance_of_in_sp,
    "small-classes": _small_classes,
}
_MADE: dict = {}


def _store(name):
    if name not in _MADE:
        _MADE[name] = STORES[name]()
    return _MADE[name]


def _rewrites(fn):
    obs.clear()
    obs.enable()
    try:
        out = fn()
    finally:
        obs.disable()
    spans = [r.attrs for r in obs.records() if r.name == "rewrite"]
    obs.clear()
    return out, spans


def _fields(res):
    return (res.class_id, res.props, res.n_triples_before,
            res.n_triples_after, res.nle_before, res.nle_after,
            res.nn_before, res.nn_after, res.surrogates.tolist(),
            sorted(res.mu_n.items()), res.star_objects.tolist())


def _mapped(store, res):
    """The rewrite before the splice: every row mapped, then sorted and
    deduplicated."""
    ents = np.asarray(sorted(res.mu_n), np.int32)
    sg = np.asarray([res.mu_n[int(e)] for e in ents], np.int32)
    return sort_unique(factorize.apply_molecule_map(
        store.spo, ents, sg, np.asarray(res.props, np.int32),
        res.class_id, store.TYPE, store.INSTANCE_OF))


@pytest.mark.parametrize("name", list(STORES))
def test_the_splice_is_the_mapped_and_sorted_graph(name):
    terms, spo, plans = _store(name)
    store = store_from_arrays(terms, spo)
    (g, results), spans = _rewrites(
        lambda: factorize.factorize_classes(store, plans))
    assert [s["path"] for s in spans] == ["splice"] * len(plans)
    before = store
    for res, span in zip(results, spans):
        assert res.graph.spo.tobytes() == _mapped(before, res).tobytes()
        assert span["moved"] == len(res.mu_n) * (len(res.props) + 1)
        assert span["rows"] == res.n_triples_after
        before = res.graph

    ref_store = JTripleStore.from_ids(JTermDict.from_terms(terms), spo)
    ref_g, ref = jfactorize_classes(ref_store, plans)
    assert g.spo.tobytes() == ref_g.spo.tobytes()
    assert [_fields(r) for r in results] == [_fields(r) for r in ref]
    got = GraphSnapshot(fgraph=FactorizedGraph.from_compaction(g, results))
    want = JGraphSnapshot(fgraph=JFactorizedGraph.from_compaction(ref_g,
                                                                  ref))
    assert got.digest() == want.digest()


def test_the_ids_of_type_and_instance_of_are_not_zero_and_one():
    """The scattered stores put both schema ids elsewhere, and one of
    them puts instanceOf below type."""
    placed = []
    for seed in range(3):
        terms, _, _ = _store(f"scattered-{seed}")
        placed.append((terms.index("rdf:type"),
                       terms.index("repro:instanceOf")))
    assert all(t > 1 and i > 1 for t, i in placed)
    assert any(i < t for t, i in placed) and any(i > t for t, i in placed)


@pytest.mark.parametrize("name", ["lsd-600", "hand-efsp", "overlap"])
def test_a_redetect_re_mints_names_and_takes_the_sort(name):
    """A redetect factorizes the decompacted classes under the names
    minted the first time: they are in the dictionary already, so G' is
    mapped and sorted, and the result is the JAX package's under its
    objective."""
    terms, spo, _ = _store(name)
    store = store_from_arrays(terms, spo)
    comp = Compactor("gfsp", "host", detector_opts={"objective": "complete"})
    ref = JCompactor("gfsp", "host")
    _, first = _rewrites(lambda: comp.run(store))
    ref.run(JTripleStore.from_ids(JTermDict.from_terms(terms), spo))
    assert first and all(s["path"] == "splice" for s in first)
    cids = sorted(comp.fgraph.tables)
    obs.clear()
    obs.enable()
    try:
        comp.redetect(cids)
    finally:
        obs.disable()
    groups = [r.attrs["groups"] for r in obs.records() if r.name == "mint"]
    spans = [r.attrs for r in obs.records() if r.name == "rewrite"]
    obs.clear()
    ref.redetect(cids)
    # a class left with no entities mints nothing and moves nothing
    assert any(groups) and len(spans) == len(groups)
    assert [s["path"] for s in spans] == \
        ["sort" if n else "splice" for n in groups]
    assert all("moved" not in s for s in spans if s["path"] == "sort")
    assert comp.snapshot.digest() == ref.snapshot.digest()
    assert comp.fgraph.store.spo.tobytes() == \
        ref.fgraph.store.spo.tobytes()


def test_rdf_type_in_sp_takes_the_sort():
    """An SP holding ``rdf:type`` would give a molecule its type row
    twice: that class is mapped and sorted, as the JAX package does."""
    terms, spo, plans = _store("small-classes")
    plans = [(plans[1][0], [*plans[1][1], terms.index("rdf:type")])]
    store = store_from_arrays(terms, spo)
    (g, results), spans = _rewrites(
        lambda: factorize.factorize_classes(store, plans))
    assert [s["path"] for s in spans] == ["sort"]
    assert len(results[0].surrogates) == 1
    ref_g, ref = jfactorize_classes(
        JTripleStore.from_ids(JTermDict.from_terms(terms), spo), plans)
    assert g.spo.tobytes() == ref_g.spo.tobytes()
    assert [_fields(r) for r in results] == [_fields(r) for r in ref]
