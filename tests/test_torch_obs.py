"""The port's span recorder (``repro_torch.obs``) on the compaction path:
off by default and silent, on after ``enable()`` or under a
``torch.profiler``, the span tree a compaction leaves (names, parents,
trace ids, class ids, row counts, self times), the profiler's user
annotations on the same clock, results unchanged by tracing, threads,
and the bounded buffer."""
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.api import Compactor
from repro_torch.convert import store_from_arrays
from repro_torch.data import synthetic as tsyn

# the parent each span may have on the gfsp path (None: a root)
PARENTS = {
    "store.load": {None}, "plan": {None}, "execute": {None},
    "index.build": {"plan", "count"},
    "detect": {"plan"}, "fold": {"plan"},
    "extract": {"detect", "star_groups", "factorize"},
    "ami.host": {"detect"}, "sweep": {"detect"}, "star_groups": {"detect"},
    "factorize": {"execute"},
    "count": {"factorize"}, "mint": {"factorize"}, "rewrite": {"factorize"},
    "fgraph.build": {"execute"},
}


@pytest.fixture(autouse=True)
def fresh_recorder():
    obs.disable()
    obs.clear()
    yield
    obs.disable()
    obs.clear()


@pytest.fixture(scope="module")
def graph():
    store = tsyn.generate(tsyn.SensorGraphSpec(n_observations=600, seed=3))
    return list(store.dict._terms), store.spo


def _compact(graph, backend="device"):
    """One op as the benchmark runs it: load, plan, execute."""
    terms, spo = graph
    store = store_from_arrays(terms, spo)
    opts = {"device": "cpu"} if backend == "device" else None
    comp = Compactor("gfsp", backend, backend_opts=opts)
    plan = comp.plan(store)
    return store, plan, comp.execute(store, plan)


def _outputs(report):
    rows = [(e.class_id, e.props, e.predicted_edges, e.baseline_edges,
             e.detection.ami, e.detection.evaluations)
            for e in report.plan]
    tables = {c: (t.props, t.surrogates.tobytes(), t.objects.tobytes())
              for c, t in report.fgraph.tables.items()}
    return rows, report.graph.spo.tobytes(), tables


def _counting_record_function(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return calls


def test_off_by_default_records_nothing_and_enters_no_record_function(
        graph, monkeypatch):
    calls = _counting_record_function(monkeypatch)
    _compact(graph)
    assert obs.records() == [] and calls == []


def test_enabled_spans_enter_record_function(graph, monkeypatch):
    calls = _counting_record_function(monkeypatch)
    obs.enable()
    _compact(graph)
    recs = obs.records()
    assert sorted(calls) == sorted(obs.PREFIX + r.name for r in recs)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_the_span_tree_of_a_compaction(graph, backend):
    obs.enable()
    store, plan, report = _compact(graph, backend)
    recs = obs.records()
    by_id = {r.span_id: r for r in recs}
    assert set(r.name for r in recs) == set(PARENTS)
    kids: dict = {}
    for r in recs:
        parent = by_id.get(r.parent_id)
        assert (parent.name if parent else None) in PARENTS[r.name], r
        root = r
        while root.parent_id is not None:
            root = by_id[root.parent_id]
        assert r.trace_id == root.span_id
        if parent is not None:
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
            kids.setdefault(parent.span_id, []).append(r)
    # self time: a span's duration less its children's, never negative
    for r in recs:
        own = (r.end_ns - r.start_ns) - sum(
            c.end_ns - c.start_ns for c in kids.get(r.span_id, ()))
        assert own >= 0, r
    roots = [r.name for r in sorted(recs, key=lambda r: r.start_ns)
             if r.parent_id is None]
    assert roots == ["store.load", "plan", "execute"]
    assert len({r.trace_id for r in recs}) == 3
    load = next(r for r in recs if r.name == "store.load")
    assert load.attrs["rows"] == len(graph[1])
    first_index = min((r for r in recs if r.name == "index.build"),
                      key=lambda r: r.start_ns)
    assert first_index.attrs["rows"] == store.n_triples
    planned = [e.class_id for e in plan]
    detects = [r for r in recs if r.name == "detect"]
    assert {r.attrs["class_id"] for r in detects} >= set(planned)
    for r in detects:
        stats = store.class_stats(r.attrs["class_id"])
        assert r.attrs["am"] == stats.n_instances
        assert r.attrs["n_s"] == stats.properties.shape[0]
    facts = sorted((r for r in recs if r.name == "factorize"),
                   key=lambda r: r.start_ns)
    assert [r.attrs["class_id"] for r in facts] == planned
    for r in recs:
        if r.name == "extract":
            assert r.attrs["rows"] >= 0 and r.attrs["cols"] >= 1
            assert r.attrs["complete"] == r.attrs["rows"]
        if r.name == "ami.host":
            assert r.attrs["rows"] == by_id[r.parent_id].attrs["am"]
        if r.name == "sweep":
            assert r.attrs["candidates"] >= 1 and r.attrs["n_b"] >= 1
            # a sensor graph's entities are all complete: every candidate
            # keeps every row
            assert r.attrs["kept"] == r.attrs["candidates"] * r.attrs["rows"]
    (fold,) = [r for r in recs if r.name == "fold"]
    assert fold.attrs == {"entries": len(plan), "rescored": 0, "dropped": 0}
    # the workspace's extraction pulls one row per complete entity
    for d in detects:
        ws = min((r for r in recs if r.name == "extract"
                  and r.parent_id == d.span_id), key=lambda r: r.start_ns)
        assert ws.attrs["rows"] == d.attrs["am"]
    last = max((r for r in recs if r.name == "rewrite"),
               key=lambda r: r.start_ns)
    assert last.attrs["rows"] == report.graph.n_triples
    mints = [r.attrs["groups"] for r in sorted(
        (r for r in recs if r.name == "mint"), key=lambda r: r.start_ns)]
    assert mints == [report.fgraph.tables[c].n_molecules for c in planned]
    fg = next(r for r in recs if r.name == "fgraph.build")
    assert fg.attrs["molecules"] == sum(mints)


def _annotation_offsets(graph):
    """One compaction under a CPU profiler with the recorder left off:
    (span, its annotation's start and end less the span's own) for every
    span, the two paired in order of start by name."""
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _compact(graph)
    recs = obs.records()
    notes: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation() and ev.name().startswith(obs.PREFIX):
            notes.setdefault(ev.name()[len(obs.PREFIX):], []).append(
                (int(ev.start_ns()), int(ev.end_ns())))
    assert recs and sum(map(len, notes.values())) == len(recs)
    out = []
    for name, spans in notes.items():
        mine = sorted((r for r in recs if r.name == name),
                      key=lambda r: r.start_ns)
        assert len(mine) == len(spans), name
        out += [(r, s - r.start_ns, e - r.end_ns)
                for r, (s, e) in zip(mine, sorted(spans))]
    return out


def test_a_profiler_turns_the_recorder_on_with_matching_annotations(graph):
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("warm"):     # the profiler's first event sets it up
            pass
    # a thread preempted between its stamp and the profiler's can read a
    # few ms apart on a loaded host: the best of three runs must agree
    for _ in range(3):
        offsets = _annotation_offsets(graph)
        worst = max(offsets, key=lambda o: max(abs(o[1]), abs(o[2])))
        if max(abs(worst[1]), abs(worst[2])) <= 1_000_000:
            break
    assert max(abs(worst[1]), abs(worst[2])) <= 1_000_000, worst
    # off again once the profiler stops
    obs.clear()
    _compact(graph)
    assert obs.records() == []


@pytest.mark.parametrize("mode", ["enable", "profiler"])
def test_results_are_the_same_with_tracing_on(graph, mode):
    plain = _outputs(_compact(graph)[2])
    if mode == "enable":
        obs.enable()
        traced = _outputs(_compact(graph)[2])
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            traced = _outputs(_compact(graph)[2])
    assert obs.records()
    assert traced == plain


def test_spans_of_two_threads_keep_their_own_parents():
    obs.enable()
    both_open = threading.Barrier(2)
    inner_done = threading.Barrier(2)

    def work(tag):
        with obs.span("outer", tag=tag):
            both_open.wait()
            with obs.span("inner", tag=tag):
                inner_done.wait()

    with obs.span("main"):
        threads = [threading.Thread(target=work, args=(t,))
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    recs = obs.records()
    by_id = {r.span_id: r for r in recs}
    outers = {r.attrs["tag"]: r for r in recs if r.name == "outer"}
    for r in recs:
        if r.name == "inner":
            parent = by_id[r.parent_id]
            assert parent is outers[r.attrs["tag"]]
            assert r.trace_id == parent.trace_id
    # a thread starts in a context of its own: its spans are roots
    assert all(r.parent_id is None for r in outers.values())
    assert len({r.trace_id for r in recs}) == 3


@pytest.mark.parametrize("extra", [1, 7])
def test_a_full_buffer_drops_the_oldest_and_counts_them(extra):
    obs.enable()
    for i in range(obs.MAX_RECORDS + extra):
        with obs.span("s", i=i):
            pass
    recs = obs.records()
    assert len(recs) == obs.MAX_RECORDS and obs.dropped() == extra
    assert recs[0].attrs["i"] == extra
    assert recs[-1].attrs["i"] == obs.MAX_RECORDS + extra - 1
    obs.clear()
    assert obs.records() == [] and obs.dropped() == 0


def test_a_span_records_and_restores_its_parent_on_an_exception():
    obs.enable()
    with obs.span("outer") as outer:
        with pytest.raises(ValueError):
            with obs.span("failing"):
                raise ValueError
        with obs.span("after"):
            pass
        outer.set(done=True)
    recs = {r.name: r for r in obs.records()}
    assert recs["failing"].parent_id == recs["outer"].span_id
    assert recs["after"].parent_id == recs["outer"].span_id
    assert recs["outer"].attrs == {"done": True}


def test_disable_stops_recording_and_the_off_span_ignores_attributes():
    obs.enable()
    with obs.span("on"):
        pass
    obs.disable()
    with obs.span("off", a=1) as sp:
        sp.set(b=2)
    assert [r.name for r in obs.records()] == ["on"]
    stamps = [obs.now_ns() for _ in range(3)]
    assert stamps == sorted(stamps)
    # the epoch clock of time.time_ns() and the profiler
    assert abs(obs.now_ns() - time.time_ns()) < 50_000_000
