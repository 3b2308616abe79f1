"""repro_torch's compressed tier against the JAX package's: the packed
columns, the front-coded blob and their byte counts byte for byte, the
front-coded dictionary, the compressed index's accessor surface, and
streamed detection (``run(stream=True)``) on the device backend with the
same plan, evaluations, digest, star-query answers and decode peak."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.api import Compactor as JCompactor
from repro.core import compress as jc
from repro.core import sweep as jsweep
from repro.core.triples import TermDict as JTermDict
from repro.data import synthetic as jsyn
from repro.query import QueryEngine as JQueryEngine
from repro_torch.api import Compactor
from repro_torch.convert import store_from_arrays
from repro_torch.core import compress as tc
from repro_torch.core import sweep
from repro_torch.core.index import GraphIndex
from repro_torch.core.triples import TermDict, TripleStore
from repro_torch.data import synthetic as tsyn
from repro_torch.query import QueryEngine, StarQuery


def _same_packed(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.data.dtype == want.data.dtype == np.uint8
    assert got.data.tobytes() == want.data.tobytes()
    assert (got.bits, got.n, got.nbytes) == (want.bits, want.n, want.nbytes)


def _same_delta(got, want):
    assert got.anchors.dtype == want.anchors.dtype
    assert got.anchors.tobytes() == want.anchors.tobytes()
    _same_packed(got.deltas, want.deltas)
    assert (got.block, got.n, got.nbytes) == (want.block, want.n,
                                              want.nbytes)


# -- bit-packed columns -------------------------------------------------------

@pytest.mark.parametrize("bits", range(1, 41))
def test_packed_ints_bytes_match_reference(bits):
    rng = np.random.default_rng(bits)
    n = 997 + 3 * bits                  # ragged: no byte or word alignment
    vals = rng.integers(0, 2 ** bits, size=n, dtype=np.int64)
    vals[0] = 2 ** bits - 1             # the full width is used
    for width in (None, bits, min(bits + 5, 48)):
        got, want = tc.PackedInts.pack(vals, width), \
            jc.PackedInts.pack(vals, width)
        _same_packed(got, want)
        assert got.bits == (bits if width is None else width)
        np.testing.assert_array_equal(got.slice_(), vals)
        for lo, hi in ((0, 1), (1, n - 1), (n // 3, n // 3 + 17),
                       (n - 5, n + 10), (7, 7)):
            a, b = got.slice_(lo, hi), want.slice_(lo, hi)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        idx = rng.integers(0, n, size=300)
        idx[:2] = (0, n - 1)
        np.testing.assert_array_equal(got.take(idx), want.take(idx))
        np.testing.assert_array_equal(got.take(idx), vals[idx])


def test_packed_ints_empty_and_negative_match_reference():
    empty = np.empty((0,), np.int64)
    _same_packed(tc.PackedInts.pack(empty), jc.PackedInts.pack(empty))
    assert tc.PackedInts.pack(empty).take(empty).shape == (0,)
    assert tc.bit_width(0) == jc.bit_width(0) == 1
    for v in (1, 2, 255, 256, 2 ** 40):
        assert tc.bit_width(v) == jc.bit_width(v)
    with pytest.raises(ValueError):
        tc.PackedInts.pack(np.array([3, -1]))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 999), bits=st.integers(1, 40),
       n=st.integers(0, 600))
def test_packed_ints_property_matches_reference(seed, bits, n):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2 ** bits, size=n, dtype=np.int64)
    got, want = tc.PackedInts.pack(vals), jc.PackedInts.pack(vals)
    _same_packed(got, want)
    if n:
        lo = int(rng.integers(0, n))
        hi = int(rng.integers(lo, n)) + 1
        np.testing.assert_array_equal(got.slice_(lo, hi), vals[lo:hi])
        idx = rng.integers(0, n, size=min(n, 64))
        np.testing.assert_array_equal(got.take(idx), want.take(idx))


@pytest.mark.parametrize("block", [1, 8, 64, 1000, 1024])
@pytest.mark.parametrize("n", [0, 1, 2500])
def test_delta_packed_bytes_match_reference(block, n):
    rng = np.random.default_rng(block + n)
    vals = np.sort(rng.integers(0, 1 << 33, size=n, dtype=np.int64))
    if n > 10:
        vals[3:9] = vals[3]             # runs of equal subjects
    got = tc.DeltaPacked.pack(vals, block=block)
    want = jc.DeltaPacked.pack(vals, block=block)
    _same_delta(got, want)
    np.testing.assert_array_equal(got.slice_(), vals)
    for lo, hi in ((0, n), (1, n - 1), (n // 2, n // 2 + block + 3),
                   (max(n - 1, 0), n + 4), (block - 1, block + 1)):
        np.testing.assert_array_equal(got.slice_(lo, hi),
                                      want.slice_(lo, hi))


def test_delta_packed_rejects_unsorted_like_reference():
    for mod in (tc, jc):
        with pytest.raises(ValueError):
            mod.DeltaPacked.pack(np.array([3, 1, 2], dtype=np.int64))


# -- front-coded terms and the compact dictionary -----------------------------

def _terms(rng, n):
    """ASCII terms and terms with two-, three- and four-byte UTF-8
    characters: ``CompactTermDict`` ranks by UTF-8 bytes, and these pin
    that the port ranks and finds them as the reference does."""
    pools = ("obs/", "sensor/", "val:", "", "é/", "時/", "ü", "\U0001f600/",
             "aé", "a￿")
    return {pools[rng.integers(0, len(pools))]
            + format(int(rng.integers(0, 10 ** 6)), "x") for _ in range(n)}


def _utf8_sorted(terms):
    return sorted(terms, key=lambda t: t.encode("utf-8"))


@pytest.mark.parametrize("bucket", [1, 4, 16, 33])
def test_front_coded_terms_match_reference(bucket):
    rng = np.random.default_rng(bucket)
    terms = _utf8_sorted(_terms(rng, 700))
    assert any(len(t.encode("utf-8")) > len(t) for t in terms)
    got = tc.FrontCodedTerms.encode(terms, bucket=bucket)
    want = jc.FrontCodedTerms.encode(terms, bucket=bucket)
    assert got.blob == want.blob
    assert got.bucket_offsets.tobytes() == want.bucket_offsets.tobytes()
    assert (got.nbytes, len(got), got.bucket) == \
        (want.nbytes, len(want), want.bucket)
    for i, t in enumerate(terms):
        assert got.get(i) == want.get(i) == t
        assert got.find(t) == want.find(t) == i
    for miss in ("zzz/not-present", "", "é", "obs/", "\U0001f600"):
        assert got.find(miss) == want.find(miss)
    with pytest.raises(IndexError):
        got.get(len(terms))


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 999), n=st.integers(1, 300),
       bucket=st.sampled_from((1, 4, 16)))
def test_front_coded_terms_property_matches_reference(seed, n, bucket):
    terms = _utf8_sorted(_terms(np.random.default_rng(seed), n))
    got = tc.FrontCodedTerms.encode(terms, bucket=bucket)
    assert got.blob == jc.FrontCodedTerms.encode(terms, bucket=bucket).blob
    assert [got.find(t) for t in terms] == list(range(len(terms)))


@pytest.mark.parametrize("n", [1, 50, 400])
def test_compact_term_dict_matches_reference(n):
    rng = np.random.default_rng(n)
    terms = list(_terms(rng, n))
    rng.shuffle(terms)                  # insertion order != sorted order
    d, jd = TermDict(), JTermDict()
    for t in terms:
        d.id(t)
        jd.id(t)
    cd, jcd = tc.CompactTermDict.from_dict(d), jc.CompactTermDict.from_dict(jd)
    assert cd._pool.blob == jcd._pool.blob
    assert cd._rank2id.tobytes() == jcd._rank2id.tobytes()
    assert cd._id2rank.tobytes() == jcd._id2rank.tobytes()
    assert (len(cd), cd.nbytes()) == (len(jcd), jcd.nbytes())
    assert cd.nbytes() < d.nbytes()
    for t in terms:
        assert cd.lookup(t) == jcd.lookup(t) == d.lookup(t)
        assert cd.term(cd.lookup(t)) == t
        assert t in cd
    assert cd.lookup("zzz/not-here") is jcd.lookup("zzz/not-here") is None
    # growth past the compacted base: a mixed batch of old and new terms
    batch = terms[:3] + ["grown/é", "grown/b", "grown/é"]
    got, want = cd.ids(batch), jcd.ids(batch)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[-3:].tolist() == [n, n + 1, n]
    assert cd.id("grown/b") == jcd.id("grown/b")
    assert [cd.term(i) for i in range(len(cd))] == \
        [jcd.term(i) for i in range(len(jcd))]
    assert (len(cd), cd.nbytes()) == (len(jcd), jcd.nbytes())


# -- the compressed index and store -------------------------------------------

@pytest.fixture(scope="module", params=["sensor", "skewed", "reified"])
def tiers(request):
    """(shape, port plain, port compressed, reference compressed), all
    from the same seeded generator (the two generators are byte-identical,
    tests/test_torch_compactor.py)."""
    spec = dict(shape=request.param, n_triples=2_500, seed=11)
    plain = tsyn.generate_workload(tsyn.WorkloadSpec(**spec))
    ref = jsyn.generate_workload(jsyn.WorkloadSpec(**spec))
    assert plain.spo.tobytes() == ref.spo.tobytes()
    return (request.param, plain, tc.compress_store(plain, max_resident=2),
            jc.compress_store(ref, max_resident=2))


def test_index_accessor_parity(tiers):
    _, plain, comp, ref = tiers
    pi, ci, ri = plain.index, comp.index, ref.index
    assert type(ci) is tc.CompressedGraphIndex
    assert ci.nbytes() == ri.nbytes()
    for i in range(pi.preds.shape[0]):
        _same_delta(ci._sub_parts[i], ri._sub_parts[i])
        _same_packed(ci._obj_parts[i], ri._obj_parts[i])
    for other in (pi, ri):
        np.testing.assert_array_equal(ci.preds, other.preds)
        np.testing.assert_array_equal(ci.starts, other.starts)
        np.testing.assert_array_equal(ci.classes(), other.classes())
    for p in pi.preds.tolist():
        for other in (pi, ri):
            np.testing.assert_array_equal(ci.pred_slice(p),
                                          other.pred_slice(p))
            np.testing.assert_array_equal(ci.pred_subjects(p),
                                          other.pred_subjects(p))
            np.testing.assert_array_equal(ci.pred_objects_sorted(p),
                                          other.pred_objects_sorted(p))
            assert ci.pred_count(p) == other.pred_count(p)
        o = int(pi.pred_slice(p)[0, 2])
        assert ci.pred_object_count(p, o) == pi.pred_object_count(p, o)
    assert ci.pred_slice(10 ** 6).shape == (0, 3)
    for cid in pi.classes().tolist():
        for other in (pi, ri):
            np.testing.assert_array_equal(ci.entities_of_class(cid),
                                          other.entities_of_class(cid))
            np.testing.assert_array_equal(ci.class_properties(cid),
                                          other.class_properties(cid))
            props = pi.class_properties(cid)[:3]
            if props.shape[0]:
                for a, b in zip(ci.object_matrix(cid, props),
                                other.object_matrix(cid, props)):
                    np.testing.assert_array_equal(a, b)
                assert ci.labeled_edge_count(cid) == \
                    other.labeled_edge_count(cid)
                assert ci.labeled_edge_count(cid, props) == \
                    other.labeled_edge_count(cid, props)
    np.testing.assert_array_equal(ci.rows, pi.rows)


def _ragged_store():
    """A class whose properties are multi-valued (``takes``), optional
    (``advisor``) and functional (``major``), some entities typed twice."""
    rng = np.random.default_rng(5)
    terms = ["rdf:type", "repro:instanceOf", "Student", "Worker", "major",
             "takes", "advisor", *(f"v/{i}" for i in range(8)),
             *(f"e/{i}" for i in range(120))]
    ents = np.arange(15, 135)
    rows = [np.stack([ents, np.zeros(120, int), np.full(120, 2)], 1),
            np.stack([ents[:40], np.zeros(40, int), np.full(40, 3)], 1),
            np.stack([ents, np.full(120, 4), 7 + rng.integers(0, 3, 120)], 1)]
    takes = np.repeat(ents, rng.integers(1, 4, 120))
    rows.append(np.stack([takes, np.full(len(takes), 5),
                          7 + rng.integers(0, 8, len(takes))], 1))
    adv = ents[rng.random(120) < 0.3]
    rows.append(np.stack([adv, np.full(len(adv), 6),
                          7 + rng.integers(0, 2, len(adv))], 1))
    return store_from_arrays(terms, np.concatenate(rows))


def test_object_table_parity_on_both_tiers(tiers):
    """``object_table`` (every entity, its one-object mask and the rows
    per property) reads the same off both tiers, on the workloads and on
    a class with multi-valued and optional properties; the folded
    objective then compacts the compressed store as the plain one."""
    _, plain, comp, _ = tiers
    ragged = _ragged_store()
    for p_store, c_store in ((plain, comp), (ragged, ragged.compressed())):
        for cid in p_store.classes().tolist():
            props = p_store.class_properties(cid)
            got = c_store.object_table(cid, props)
            want = p_store.object_table(cid, props)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    ents, objs, one, n_p = ragged.object_table(2, [4, 5, 6])
    assert one[:, 0].all() and not one[:, 1].all() and not one[:, 2].all()
    assert n_p.tolist() == [ragged.labeled_edge_count(2, [p])
                            for p in (4, 5, 6)]
    for det in ("gfsp", "efsp"):
        a = Compactor(det, "device", backend_opts={"device": "cpu"})
        b = Compactor(det, "device", backend_opts={"device": "cpu"})
        ra = a.run(ragged)
        rb = b.run(ragged.compressed(), stream=True)
        assert a.snapshot.digest() == b.snapshot.digest()
        assert [(e.class_id, e.props, e.predicted_edges, e.baseline_edges)
                for e in ra.plan] == \
            [(e.class_id, e.props, e.predicted_edges, e.baseline_edges)
             for e in rb.plan]
        assert ra.plan


def test_compressed_rows_and_accounting(tiers):
    _, plain, comp, ref = tiers
    assert comp.is_compressed and not plain.is_compressed
    np.testing.assert_array_equal(plain.spo, comp.spo)
    assert comp.n_triples == plain.n_triples == ref.n_triples
    for a, b in ((comp._cspo.lead, ref._cspo.lead),):
        _same_delta(a, b)
    _same_packed(comp._cspo.mid, ref._cspo.mid)
    _same_packed(comp._cspo.trail, ref._cspo.trail)
    assert comp.substrate_nbytes() == ref.substrate_nbytes()
    assert comp.substrate_nbytes(include_dict=False) == \
        ref.substrate_nbytes(include_dict=False)
    assert comp.substrate_nbytes() < 0.5 * plain.substrate_nbytes()


def test_inherited_store_methods_read_through_the_compressed_rows(tiers):
    """Every TripleStore method the compressed store inherits reads the
    rows through the virtualized ``_spo``: after the decode cache is
    dropped they still answer as the plain store does."""
    _, plain, comp, _ = tiers
    comp.release_decoded()
    assert comp._dec_spo is None
    np.testing.assert_array_equal(comp.nodes(), plain.nodes())
    assert comp.size == plain.size
    assert comp.triples_as_terms()[:50] == plain.triples_as_terms()[:50]
    subs = plain.spo[::97, 0]
    np.testing.assert_array_equal(comp.restrict_subjects(subs).spo,
                                  plain.restrict_subjects(subs).spo)
    cid = int(plain.classes()[0])
    assert comp.class_stats(cid).n_instances == \
        plain.class_stats(cid).n_instances
    dup = comp.copy()
    assert type(dup) is tc.CompressedTripleStore and dup._cspo is comp._cspo
    np.testing.assert_array_equal(dup.spo, plain.spo)
    # appends re-compress and merge the index into the plain tier
    new = np.array([[plain.spo[0, 0], plain.spo[0, 1], 10 ** 6],
                    plain.spo[1]], np.int32)
    dup.add_ids(new)
    want = plain.copy()
    want.add_ids(new)
    dup.release_decoded()
    np.testing.assert_array_equal(dup.spo, want.spo)
    assert dup.n_triples == want.n_triples
    np.testing.assert_array_equal(dup.index.rows, want.index.rows)
    dup.spo = plain.spo[:100]
    assert dup._cspo.n == 100 and dup.is_compressed
    np.testing.assert_array_equal(dup.spo, plain.spo[:100])
    assert comp.n_triples == plain.n_triples      # the original untouched


def test_mutation_returns_plain_tier(tiers):
    """filtered/merged leave the read-optimized tier: mutating a
    compressed index re-materializes a plain GraphIndex."""
    _, plain, comp, ref = tiers
    keep = np.ones(plain.n_triples, dtype=bool)
    keep[::7] = False
    fi = comp.index.filtered(keep)
    assert type(fi) is GraphIndex
    np.testing.assert_array_equal(fi.rows, plain.index.filtered(keep).rows)
    np.testing.assert_array_equal(fi.rows, ref.index.filtered(keep).rows)
    extra = np.array([[10 ** 6, plain.TYPE, int(plain.classes()[0])]],
                     np.int32)
    mi = comp.index.merged(extra)
    assert type(mi) is GraphIndex
    np.testing.assert_array_equal(mi.rows, plain.index.merged(extra).rows)


def _plan_rows(report):
    return [(e.class_id, e.props, e.predicted_edges, e.baseline_edges,
             e.detection.props, e.detection.edges, e.detection.ami,
             e.detection.am, e.detection.evaluations,
             e.detection.iterations) for e in report.plan]


def _queries(fg):
    out = []
    for cid, t in sorted(fg.tables.items()):
        for row in t.objects[:4]:
            out.append(StarQuery(
                arms=tuple((int(p), int(o)) for p, o in zip(t.props, row)),
                class_id=cid))
            out.append(StarQuery(
                arms=((int(t.props[0]), int(row[0])),
                      (int(t.props[-1]), None)), class_id=cid))
    return out


def test_streamed_device_detection_matches_reference(tiers):
    shape, plain, comp, ref = tiers
    jcomp = JCompactor("gfsp")
    want = jcomp.run(ref, stream=True)
    tcomp = Compactor("gfsp", "device", backend_opts={"device": "cpu"})
    got = tcomp.run(comp, stream=True)
    assert _plan_rows(got) == _plan_rows(want)
    assert got.graph.spo.tobytes() == want.graph.spo.tobytes()
    assert tcomp.snapshot.digest() == jcomp.snapshot.digest()
    # and the plain tier's run gives the same plan and digest
    pcomp = Compactor("gfsp", "host")
    assert _plan_rows(pcomp.run(plain)) == _plan_rows(got)
    assert pcomp.snapshot.digest() == tcomp.snapshot.digest()

    queries = _queries(tcomp.fgraph)
    if not queries:
        pytest.skip(f"{shape} produced no factorized tables at this size")
    jeng = JQueryEngine(jcomp.snapshot.fgraph, use_kernel=False)
    eng = QueryEngine(tcomp.fgraph, device="cpu")
    for q, b, h in zip(queries, eng.query_batch(queries, backend="device"),
                       eng.query_batch(queries)):
        w = jeng.query(q).canonical()
        for res in (b, h):
            c = res.canonical()
            assert c.shape == w.shape and (c == w).all(), q


def test_streamed_detection_bounds_resident_decodes(tiers):
    """stream=True releases per-class decodes between classes: the peak
    resident bytes stay a fraction of the plain substrate, and equal the
    reference's on the same run; the port's one reset clears them."""
    _, plain, comp, ref = tiers
    jsweep.reset_trace_stats()
    JCompactor("gfsp").run(ref, stream=True)
    want = dict(jc.DECODE_STATS)
    tc.DECODE_STATS["peak_resident_bytes"] = -1
    sweep.reset_trace_stats()
    assert tc.DECODE_STATS == {"partitions": 0, "values": 0,
                               "resident_bytes": 0, "peak_resident_bytes": 0}
    Compactor("gfsp", "device", backend_opts={"device": "cpu"}).run(
        comp, stream=True)
    peak = tc.DECODE_STATS["peak_resident_bytes"]
    assert 0 < peak < 0.5 * plain.substrate_nbytes()
    assert peak == want["peak_resident_bytes"]
    assert tc.DECODE_STATS["partitions"] == want["partitions"]


def test_streaming_releases_between_classes():
    """plan(stream=True) calls release_transients once per class that
    reaches detection; without stream it never does."""
    store = tsyn.generate_workload(tsyn.WorkloadSpec(
        shape="sensor", n_triples=2_000, seed=3))
    calls = []

    class Counting(TripleStore):
        def release_transients(self):
            calls.append(1)

    counted = Counting(store.dict, store.spo, presorted=True)
    comp = Compactor("gfsp")
    plan = comp.plan(counted)
    assert not calls
    streamed = comp.plan(counted, stream=True)
    assert [(e.class_id, e.props, e.predicted_edges) for e in streamed] == \
        [(e.class_id, e.props, e.predicted_edges) for e in plan]
    detected = [c for c in counted.classes()
                if counted.class_stats(int(c)).properties.shape[0] >= 2]
    assert len(calls) == len(detected) > 0


def test_tier_from_store_method_keeps_ids():
    store = tsyn.figure1_graph()
    c = store.compressed()
    assert c.is_compressed and type(c.dict) is tc.CompactTermDict
    shared = store.compressed(compact_dict=False)
    assert shared.dict is store.dict
    for i in range(len(store.dict)):
        assert c.dict.term(i) == store.dict.term(i)
    np.testing.assert_array_equal(c.spo, store.spo)
    a, b = Compactor("gfsp"), Compactor("gfsp")
    a.run(store)
    b.run(c, stream=True)
    assert a.snapshot.digest() == b.snapshot.digest()
