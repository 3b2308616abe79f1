"""The port's mutation path against the JAX package on the same inputs:
``Compactor.update``/``delete``/``redetect`` (and the planner's
``apply_update``/``apply_delete``/``redetect`` under them), carried
across with ``convert.store_from_arrays`` -- equal ``spo`` bytes,
molecule tables, dictionary terms, reports, ``DeleteStats`` and
digests after every step, on the host backend and on the device backend
run on the CPU, at three savings thresholds and two surrogate prefixes.

The reference is imported inside the ``R`` fixture (it pulls in jax),
so on a machine without jax this file still imports and every case
skips."""
import dataclasses
import types

import numpy as np
import pytest

from repro_torch.api import Compactor, DeviceBackend, register_backend, \
    register_detector
from repro_torch.convert import store_from_arrays
from repro_torch.core import sweep
from repro_torch.core.fgraph import MoleculeTable

WORKLOADS = ("sensor", "skewed", "hierarchy", "reified", "adversarial")
GRAPHS = ["sensor30", "sensor60", *[f"workload-{s}" for s in WORKLOADS]]
# (min_predicted_savings, surrogate_prefix)
CONFIGS = [(1, "repro:sg"), (50, "repro:sg"), (10**9, "repro:sg"),
           (1, "ex:m")]


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    from repro.api import Compactor as JCompactor
    from repro.data import synthetic as jsyn
    return types.SimpleNamespace(Compactor=JCompactor, syn=jsyn)


def _build(mod, name):
    if name.startswith("sensor"):
        return mod.generate(mod.SensorGraphSpec(
            n_observations=int(name[6:]), seed=4))
    shape = name.split("-", 1)[1]
    return mod.generate_workload(mod.WorkloadSpec(shape=shape,
                                                  n_triples=5_000, seed=0))


def _pair(R, name):
    """(reference store, the port's copy of it)."""
    ref = _build(R.syn, name)
    return ref, store_from_arrays(list(ref.dict._terms), ref.spo)


def _backend(kind):
    return DeviceBackend(device="cpu") if kind == "device" else "host"


def tables(fg):
    return [(c, t.props, t.surrogates.tobytes(), t.objects.tobytes(),
             t.next_ordinal) for c, t in sorted(fg.tables.items())]


def same_state(jc, tc, what=""):
    """The two compactors hold the same snapshot: G' bytes, tables,
    dictionary, epoch, membership and digest; the port's validates."""
    assert tc.graph.spo.tobytes() == jc.graph.spo.tobytes(), what
    assert tables(tc.fgraph) == tables(jc.fgraph), what
    assert tc.graph.dict._terms == jc.graph.dict._terms, what
    assert tc.snapshot.epoch == jc.snapshot.epoch, what
    assert tc.fgraph.payoff_min_support == jc.fgraph.payoff_min_support
    assert tc.fgraph._mem.tobytes() == jc.fgraph._mem.tobytes(), what
    assert tc.snapshot.digest() == jc.snapshot.digest(), what
    tc.fgraph.validate()


def report_fields(rep):
    """A report's fields without its wall times and its store."""
    out = {}
    for f in dataclasses.fields(rep):
        v = getattr(rep, f.name)
        if f.name.endswith("_ms") or f.name == "graph":
            continue
        if f.name == "stats":
            v = dataclasses.asdict(v)
        elif f.name == "plan":
            v = [(e.class_id, e.props, e.predicted_edges, e.baseline_edges)
                 for e in v]
        out[f.name] = v
    return out


def _entity_inserts(store, rng, tag, n_clone, n_novel):
    """Term triples of complete entities of every class with >= 2
    properties: ``n_clone`` cloning an existing object tuple (surrogate
    reuse), ``n_novel`` with pairwise-novel tuples (fresh surrogates)."""
    term = store.dict.term
    out = []
    for cid in [int(c) for c in store.classes()][:4]:
        props = np.asarray(store.class_properties(cid))
        if props.shape[0] < 2:
            continue
        _, mat = store.object_matrix(cid, props)
        cterm, tterm = term(cid), term(store.TYPE)
        pterms = [term(int(p)) for p in props]
        for j in range(n_clone if mat.shape[0] else 0):
            s = f"e:c/{tag}/{cid}/{j}"
            row = mat[int(rng.integers(0, mat.shape[0]))]
            out.append((s, tterm, cterm))
            out += [(s, p, term(int(o))) for p, o in zip(pterms, row)]
        for j in range(n_novel):
            s = f"e:n/{tag}/{cid}/{j}"
            out.append((s, tterm, cterm))
            out += [(s, p, f"o:n/{tag}/{cid}/{j}/{k}")
                    for k, p in enumerate(pterms)]
    return out


def _deletes(fg, rng):
    """Triples and entities to delete from one snapshot: arms of
    absorbed members (each dissolves a membership), a member's moved
    type edge, raw triples, an absent triple, and entities that are
    members or referenced in molecule arms."""
    store = fg.store
    trips, ents = [], []
    for cid, t in sorted(fg.tables.items()):
        if not t.n_molecules:
            continue
        for r in rng.integers(0, t.n_molecules, 3).tolist():
            mem = fg.members(int(t.surrogates[r]))
            if mem.shape[0]:
                m = int(mem[0])
                j = int(rng.integers(0, t.k))
                trips.append((m, t.props[j], int(t.objects[r, j])))
                if mem.shape[0] > 1:
                    trips.append((int(mem[1]), store.TYPE, cid))
                ents.append(int(mem[-1]))
        ents.append(int(t.objects[int(rng.integers(0, t.n_molecules)), 0]))
    raw = store.spo[(store.spo[:, 1] != store.INSTANCE_OF)
                    & ~fg.is_surrogate(store.spo[:, 0])]
    for i in (rng.integers(0, raw.shape[0], 4).tolist()
              if raw.shape[0] else []):
        trips.append(tuple(int(x) for x in raw[i]))
    trips.append((0, store.TYPE, 1))                   # absent
    return (np.asarray(trips, np.int32).reshape(-1, 3),
            np.unique(np.asarray(ents, np.int64)))


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("name", GRAPHS)
def test_mutation_sequence_matches_reference(R, name, config, backend):
    """run -> term-level update -> id-level update -> delete (triples,
    then entities) -> redetect -> a warm redetect: both packages agree
    on every report and every intermediate snapshot."""
    mps, prefix = config
    ref, store = _pair(R, name)
    jc = R.Compactor("gfsp", "host", min_predicted_savings=mps,
                     surrogate_prefix=prefix)
    # the edits leave incomplete molecules: the port scores them as the
    # JAX package does only under the complete objective
    tc = Compactor("gfsp", _backend(backend), min_predicted_savings=mps,
                   surrogate_prefix=prefix,
                   detector_opts={"objective": "complete"})
    assert (tc.min_predicted_savings, tc.surrogate_prefix) == (mps, prefix)
    jc.run(ref)
    tc.run(store)
    same_state(jc, tc, "run")

    rng = np.random.default_rng(7)
    ins = _entity_inserts(ref, rng, "t", 4, 3)
    ju, tu = jc.update(ins), tc.update(ins)
    assert report_fields(tu) == report_fields(ju)
    same_state(jc, tc, "term update")

    # id level: the same terms minted in both dictionaries first
    ins = _entity_inserts(ref, rng, "i", 3, 2)
    flat = [x for t in ins for x in t]
    rows = ref.dict.ids(flat).reshape(-1, 3)
    assert np.array_equal(store.dict.ids(flat).reshape(-1, 3), rows)
    ju, tu = jc.update(rows), tc.update(rows)
    assert report_fields(tu) == report_fields(ju)
    same_state(jc, tc, "id update")

    trips, ents = _deletes(jc.fgraph, np.random.default_rng(3))
    jd, td = jc.delete(triples=trips), tc.delete(triples=trips)
    assert report_fields(td) == report_fields(jd)
    same_state(jc, tc, "triple delete")
    jd, td = jc.delete(entities=ents), tc.delete(entities=ents)
    assert report_fields(td) == report_fields(jd)
    same_state(jc, tc, "entity delete")

    cids = sorted({int(c) for c in ref.classes()})[:4]
    jr, tr = jc.redetect(cids), tc.redetect(cids)
    want = report_fields(jr)
    got = report_fields(tr)
    if backend == "device":
        # the device backend launches one batch per descent
        assert got.pop("lowerings") == got["descents"]
        want.pop("lowerings")
    assert got == want
    same_state(jc, tc, "redetect")

    # warm: the same classes again see no new bucket shape
    sweep.reset_trace_stats()
    jr, tr = jc.redetect(cids), tc.redetect(cids)
    assert tr.descents == jr.descents
    assert (tr.considered, tr.refactorized, tr.rejected) == \
        (jr.considered, jr.refactorized, jr.rejected)
    assert sweep.trace_count() == 0, dict(sweep.TRACE_COUNTS)
    same_state(jc, tc, "warm redetect")


@pytest.mark.parametrize("name", ["sensor60", "workload-skewed"])
def test_term_level_deletes_and_rejections_match(R, name):
    """Term-level deletes: unknown terms count as requested and never
    grow the dictionary; deleting a surrogate's triple, an instanceOf
    link or a surrogate entity raises in both packages."""
    ref, store = _pair(R, name)
    jc, tc = R.Compactor(), Compactor()
    jc.run(ref)
    tc.run(store)
    fg = tc.fgraph
    term = store.dict.term
    cid, t = next(iter(sorted(fg.tables.items())))
    sg = int(t.surrogates[0])
    m = int(fg.members(sg)[0])
    trips = [(term(m), term(t.props[0]), term(int(t.objects[0, 0]))),
             ("e:ghost", term(t.props[0]), "o:ghost"),
             (term(m), term(store.TYPE), term(cid))]
    ents = [term(int(fg.members(int(t.surrogates[-1]))[0])), "e:never"]
    n_terms = len(store.dict)
    jd = jc.delete(triples=trips, entities=ents)
    td = tc.delete(triples=trips, entities=ents)
    assert report_fields(td) == report_fields(jd)
    assert len(store.dict) == n_terms
    same_state(jc, tc, "term deletes")
    sg = int(tc.fgraph.surrogate_ids[0])
    bad = [dict(triples=np.asarray([[sg, store.TYPE, cid]], np.int32)),
           dict(triples=np.asarray([[m, store.INSTANCE_OF, sg]], np.int32)),
           dict(entities=np.asarray([sg], np.int64))]
    for kw in bad:
        with pytest.raises(ValueError) as je:
            jc.delete(**kw)
        with pytest.raises(ValueError) as te:
            tc.delete(**kw)
        assert str(te.value) == str(je.value)
    same_state(jc, tc, "rejected deletes change nothing")


@pytest.mark.parametrize("backend", ["host", "device"])
def test_update_on_the_compressed_tier_migrates_like_the_reference(
        R, backend):
    """``apply_update`` on a snapshot whose store is on the compressed
    tier migrates it to the plain tier (one decode, the index filtered
    and merged per class), exactly as ``repro`` does: same G', tables,
    dictionary and digest, then a redetect on the migrated store."""
    from repro.core.compress import compress_store as jcompress
    ref, store = _pair(R, "sensor60")
    jc = R.Compactor("gfsp", "host")
    tc = Compactor("gfsp", _backend(backend))
    jc.run(ref)
    tc.run(store)
    jsnap = jc.snapshot.next(jc.fgraph.with_store(jcompress(jc.graph)))
    tsnap = tc.snapshot.next(tc.fgraph.with_store(tc.graph.compressed()))
    assert tsnap.store.is_compressed and jsnap.store.is_compressed
    assert tsnap.digest() == jsnap.digest() == tc.snapshot.digest()
    ins = _entity_inserts(ref, np.random.default_rng(1), "c", 3, 2)
    jsnap, ju = jc.planner.apply_update(jsnap, ins)
    tsnap, tu = tc.planner.apply_update(tsnap, ins)
    assert not tsnap.store.is_compressed and not jsnap.store.is_compressed
    assert report_fields(tu) == report_fields(ju)
    assert tsnap.store.spo.tobytes() == jsnap.store.spo.tobytes()
    assert tables(tsnap.fgraph) == tables(jsnap.fgraph)
    td, jd = tsnap.store.dict, jsnap.store.dict
    assert [td.term(i) for i in range(len(td))] == \
        [jd.term(i) for i in range(len(jd))]
    assert tsnap.digest() == jsnap.digest()
    tsnap.fgraph.validate()
    cids = sorted(tsnap.fgraph.tables)
    (jsnap, jr), (tsnap, tr) = (jc.planner.redetect(jsnap, cids),
                                tc.planner.redetect(tsnap, cids))
    assert (tr.refactorized, tr.descents, tr.edges_after, tr.epoch) == \
        (jr.refactorized, jr.descents, jr.edges_after, jr.epoch)
    assert tsnap.digest() == jsnap.digest()


@pytest.mark.parametrize("name", ["sensor30", "workload-hierarchy",
                                  "workload-reified"])
def test_decompact_classes_and_snapshot_state_match(R, name):
    """``decompact_classes`` of each class alone, and ``to_state`` /
    ``from_state``: the same arrays and meta as ``repro``, and a
    round trip that keeps the digest."""
    from repro_torch.api import GraphSnapshot
    ref, store = _pair(R, name)
    jc, tc = R.Compactor(), Compactor()
    jc.run(ref)
    tc.run(store)
    for cid in sorted(tc.fgraph.tables):
        jd = jc.fgraph.decompact_classes([cid, 10**6])
        td = tc.fgraph.decompact_classes([cid, 10**6])
        assert td.store.spo.tobytes() == jd.store.spo.tobytes()
        assert tables(td) == tables(jd)
        td.validate()
    assert tc.fgraph.decompact_classes([]) is tc.fgraph
    ja, jm = jc.snapshot.to_state()
    ta, tm = tc.snapshot.to_state()
    assert tm == jm and sorted(ta) == sorted(ja)
    for k in ta:
        assert ta[k].tobytes() == ja[k].tobytes() and \
            ta[k].dtype == ja[k].dtype, k
    back = GraphSnapshot.from_state(store.dict, ta, tm)
    assert back.epoch == tc.snapshot.epoch
    assert back.digest() == tc.snapshot.digest()
    assert tables(back.fgraph) == tables(tc.fgraph)
    nxt = tc.snapshot.next(back.fgraph)
    assert nxt.epoch == tc.snapshot.epoch + 1 and nxt.fgraph is back.fgraph


def test_with_rows_appends_like_the_reference(R):
    """``MoleculeTable.with_rows``: the amortized append chain, the
    copy-on-branch guard, the ``sig`` ownership transfer and the
    non-ascending fallback give the reference's rows and maps, and an
    older table never sees a successor's rows."""
    from repro.core.fgraph import MoleculeTable as JTable
    rng = np.random.default_rng(0)
    base = dict(class_id=3, props=(5, 2),
                surrogates=np.asarray([40, 10, 20], np.int32),
                objects=rng.integers(0, 9, (3, 2)).astype(np.int32),
                next_ordinal=3)
    tt, jt = MoleculeTable(**base), JTable(**base)
    chain_t, chain_j = [tt], [jt]
    nxt = 41
    for step in range(12):
        n = int(rng.integers(0, 5))
        s = np.arange(nxt, nxt + n, dtype=np.int32)
        o = rng.integers(0, 9, (n, 2)).astype(np.int32)
        nxt += n
        if step % 3 == 0:
            chain_t[-1].sig, chain_j[-1].sig          # sig built: transfer
        src = -2 if step == 5 and len(chain_t) > 1 else -1   # a branch
        if step == 8:                                 # non-ascending
            s = np.asarray([1, 0], np.int32)[:n] if n else s
            o = o[:s.shape[0]]
        chain_t.append(chain_t[src].with_rows(s, o, nxt))
        chain_j.append(chain_j[src].with_rows(s, o, nxt))
    for t, j in zip(chain_t, chain_j):
        assert t.surrogates.tobytes() == j.surrogates.tobytes()
        assert t.objects.tobytes() == j.objects.tobytes()
        assert t.next_ordinal == j.next_ordinal
        assert t.sig == j.sig
        assert [t.row_of(int(x)) for x in t.surrogates] == \
            list(range(t.n_molecules))
    with pytest.raises(KeyError):
        chain_t[0].row_of(10**6)
    drop = [0, chain_t[-1].n_molecules - 1]
    w_t, w_j = chain_t[-1].without_rows(drop), chain_j[-1].without_rows(drop)
    assert w_t.surrogates.tobytes() == w_j.surrogates.tobytes()
    assert w_t.objects.tobytes() == w_j.objects.tobytes()


def test_registered_strategies_drive_the_compactor(R):
    """``register_detector``/``register_backend`` add strategies the
    ``Compactor`` resolves by name, as in ``repro``."""
    from repro_torch.api import BACKENDS, DETECTORS, HostBackend, Registry
    from repro_torch.api.detectors import GreedyDetector

    class Fixed(GreedyDetector):
        name = "fixed-greedy"

    class Counting(HostBackend):
        name = "counting"
        calls = 0

        def workspace(self, *a):
            Counting.calls += 1
            return super().workspace(*a)

    register_detector("fixed-greedy", Fixed)
    register_backend("counting", Counting)
    assert isinstance(DETECTORS, Registry) and isinstance(BACKENDS, Registry)
    assert "fixed-greedy" in DETECTORS.names()
    ref, store = _pair(R, "sensor30")
    got = Compactor("fixed-greedy", "counting").run(store)
    want = R.Compactor("gfsp", "host").run(ref)
    assert Counting.calls > 0
    assert got.plan.detector == "fixed-greedy"
    assert got.graph.spo.tobytes() == want.graph.spo.tobytes()
