"""The port's sharded graph against the JAX package's on the same seeded
stores: ``ShardPlan.build`` (1, 2, 4 and 8 shards at oversplit 2 and
4), ``partition``, ``detect_all`` sequential and fork-parallel on the
host (digest, the shared dictionary's minted terms, tables, traffic),
the planner's ``plan``/``redetect`` with ``sharded_graph=``, the
fan-out ``ShardedQueryEngine`` (star, batch and BGP bindings),
``ShardedQueryService`` (parity, all-or-nothing shedding, the
coordinator deadline, a device failure that raises, the host backend's
fallback), ``swap_shard`` after ``online.recover``, and
``serve_sharded_queries``' result dict -- every comparison exact,
timings aside.  The reference is imported inside the ``R`` fixture (it
pulls in jax); the sharded graph itself needs no mesh here."""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import CompactionPlanner
from repro_torch.core.triples import TripleStore
from repro_torch.data.synthetic import SensorGraphSpec, generate
from repro_torch.dist.graph import (ShardedFactorizedGraph,
                                    ShardedQueryEngine, ShardPlan)
from repro_torch.launch import serve
from repro_torch.online import OnlineCompactionService, recover
from repro_torch.query import (BGPQuery, Filter, StarPattern, StarQuery,
                               eval_raw)
from repro_torch.serving import (BGPQueryRequest, GraphQueryRequest,
                                 GraphQueryService, ShardedQueryService)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    import repro.launch.serve as jserve
    import repro.serving as jserving
    from repro.api import CompactionPlanner as JPlanner
    from repro.data import synthetic as syn
    from repro.dist import graph as jgraph
    from repro.query import QueryEngine as JQueryEngine
    from repro.query.bgp import algebra as jalg
    return types.SimpleNamespace(Planner=JPlanner, syn=syn, graph=jgraph,
                                 QueryEngine=JQueryEngine, serving=jserving,
                                 serve=jserve, alg=jalg)


def _pair(R, n=200, seed=7):
    """The same sensor graph from both packages' generators."""
    ref = R.syn.generate(R.syn.SensorGraphSpec(n_observations=n, seed=seed))
    port = generate(SensorGraphSpec(n_observations=n, seed=seed))
    assert port.spo.tobytes() == ref.spo.tobytes()
    return ref, port


def _plan_fields(p):
    return (p.n_shards, p.owner_entities.dtype.str,
            p.owner_entities.tobytes(), p.owner_shard.dtype.str,
            p.owner_shard.tobytes(), dict(p.pred_shard),
            dict(p.class_shards), dict(p.class_props), p.shard_weights,
            p.n_chunks, p.split_classes)


def _shards(sharded):
    """Each shard's epoch, rows and molecule tables, as bytes."""
    out = []
    for s in sharded.snapshots:
        fg = s.fgraph
        out.append((s.epoch, fg.store.spo.tobytes(), sorted(
            (cid, t.props, t.surrogates.tobytes(), t.objects.tobytes())
            for cid, t in fg.tables.items())))
    return out


def _no_ms(report):
    return {"split_class_ami": report["split_class_ami"],
            "shards": {sid: {k: v for k, v in r.items() if k != "detect_ms"}
                       for sid, r in report["shards"].items()}}


# ---------------------------------------------------------------------------
# the shard plan and the partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("oversplit", [2, 4])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shard_plan_equals_jax(R, n_shards, oversplit):
    ref, port = _pair(R, 400)
    want = R.graph.ShardPlan.build(ref, n_shards, oversplit=oversplit)
    got = ShardPlan.build(port, n_shards, oversplit=oversplit)
    assert _plan_fields(got) == _plan_fields(want)
    assert np.asarray(got.shard_weights).sum() == port.n_triples
    assert got.route_rows(port.spo).tobytes() == \
        want.route_rows(ref.spo).tobytes()
    for cid in list(got.class_shards) + [10 ** 6]:
        assert got.shards_for_class(cid) == want.shards_for_class(cid)
    if n_shards >= 4 and oversplit == 4:
        assert got.split_classes          # the sensor shape chunk-splits


def test_shard_plan_rejects_zero_shards():
    with pytest.raises(ValueError):
        ShardPlan.build(generate(SensorGraphSpec(n_observations=20)), 0)


def test_partition_equals_jax_and_keeps_every_row_once(R):
    ref, port = _pair(R)
    want = R.graph.ShardedFactorizedGraph.partition(ref, 3)
    got = ShardedFactorizedGraph.partition(port, 3)
    assert _shards(got) == _shards(want)
    parts = [s.fgraph.store.spo for s in got.snapshots]
    assert sum(p.shape[0] for p in parts) == port.n_triples
    assert np.array_equal(np.unique(np.concatenate(parts), axis=0),
                          np.unique(port.spo, axis=0))
    assert got.shard_nbytes() == want.shard_nbytes()
    assert got.n_triples == want.n_triples and got.epoch == 0
    with pytest.raises(ValueError):
        ShardedFactorizedGraph(port.dict, got.plan, got.snapshots[:2])


# ---------------------------------------------------------------------------
# shard-local detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards,parallel", [(1, False), (2, False),
                                               (4, False), (3, True)])
def test_detect_all_on_host_equals_jax(R, n_shards, parallel):
    ref, port = _pair(R)
    jsh = R.graph.ShardedFactorizedGraph.partition(ref, n_shards)
    jrep = jsh.detect_all(backend="host", parallel=parallel)
    sh = ShardedFactorizedGraph.partition(port, n_shards)
    before = sh.snapshots
    rep = sh.detect_all(backend="host", parallel=parallel)
    assert _no_ms(rep) == _no_ms(jrep)
    assert sh.snapshots is not before and sh.epoch == 1
    assert sh.digest() == jsh.digest()
    assert _shards(sh) == _shards(jsh)
    # the minted surrogates, in the one shared dictionary, with ids
    assert port.dict._terms == ref.dict._terms
    assert all(s.fgraph.store.dict is port.dict for s in sh.snapshots)
    assert sh.traffic == jsh.traffic
    assert sh.shard_nbytes() == jsh.shard_nbytes()
    assert sh.n_triples == jsh.n_triples
    assert sh.expand_union().spo.tobytes() == \
        jsh.expand_union().spo.tobytes()
    snap, _ = CompactionPlanner("gfsp", "host").run(port.copy())
    assert sh.digest() == snap.digest()


def test_detect_all_on_the_device_backend_equals_host(R):
    _, port = _pair(R)
    host = ShardedFactorizedGraph.partition(port.copy(), 4, oversplit=4)
    host_rep = host.detect_all(backend="host")
    dev = ShardedFactorizedGraph.partition(port.copy(), 4, oversplit=4)
    dev_rep = dev.detect_all(backend="device", device="cpu")
    assert _no_ms(dev_rep) == _no_ms(host_rep)
    assert _shards(dev) == _shards(host)
    assert dev.digest() == host.digest()


def test_parallel_detection_refuses_a_device_backend_on_cuda(monkeypatch):
    port = generate(SensorGraphSpec(n_observations=40, seed=7))
    sh = ShardedFactorizedGraph.partition(port, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sh.detect_all(backend="device", parallel=True)
    # on a host that has a card, the fork is refused before any launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="forked child cannot use"):
        sh.detect_all(backend="device", parallel=True)
    assert sh.epoch == 0                       # nothing was swapped


def test_parallel_detection_on_the_cpu_device_backend(R):
    _, port = _pair(R)
    seq = ShardedFactorizedGraph.partition(port.copy(), 3)
    seq.detect_all(backend="host")
    par = ShardedFactorizedGraph.partition(port.copy(), 3)
    par.detect_all(backend="device", device="cpu", parallel=True)
    assert _shards(par) == _shards(seq)


def test_swap_and_swap_shard_are_one_tuple_store(R):
    _, port = _pair(R)
    sh = ShardedFactorizedGraph.partition(port, 3)
    sh.detect_all(backend="host")
    before = sh.snapshots
    sh.swap_shard(1, before[1])
    after = sh.snapshots
    assert after is not before
    assert after[0] is before[0] and after[2] is before[2]
    with pytest.raises(ValueError):
        sh.swap(before[:2])


# ---------------------------------------------------------------------------
# the planner's sharded paths
# ---------------------------------------------------------------------------

def _plan_rows(plan):
    return [(e.class_id, e.props, e.predicted_edges, e.baseline_edges,
             e.detection.props, e.detection.edges, e.detection.ami,
             e.detection.evaluations) for e in plan]


def _redetect_fields(rep):
    return {f.name: (_plan_rows(getattr(rep, f.name)) if f.name == "plan"
                     else getattr(rep, f.name))
            for f in dataclasses.fields(rep) if f.name != "exec_time_ms"}


def test_plan_and_redetect_with_a_sharded_graph_equal_jax(R):
    ref, port = _pair(R)
    jsh = R.graph.ShardedFactorizedGraph.partition(ref, 2)
    sh = ShardedFactorizedGraph.partition(port, 2)
    jplans = R.Planner("gfsp", "host").plan(sharded_graph=jsh)
    plans = CompactionPlanner("gfsp", "host").plan(sharded_graph=sh)
    assert set(plans) == set(jplans) == {0, 1}
    assert {s: _plan_rows(p) for s, p in plans.items()} == \
        {s: _plan_rows(p) for s, p in jplans.items()}
    with pytest.raises(ValueError):
        CompactionPlanner("gfsp", "host").plan()

    jsh.detect_all(backend="host")
    sh.detect_all(backend="host")
    digest = sh.digest()
    dirty = [int(c) for c in port.classes()][:1]
    before = sh.snapshots
    out, reports = CompactionPlanner("gfsp", "host").redetect(
        None, dirty, sharded_graph=sh)
    _, jreports = R.Planner("gfsp", "host").redetect(
        None, dirty, sharded_graph=jsh)
    assert out is sh and sh.snapshots is not before
    assert sh.digest() == digest == jsh.digest()
    assert {s: _redetect_fields(r) for s, r in reports.items()} == \
        {s: _redetect_fields(r) for s, r in jreports.items()}
    assert _shards(sh) == _shards(jsh)
    assert port.dict._terms == ref.dict._terms


# ---------------------------------------------------------------------------
# the fan-out query engine
# ---------------------------------------------------------------------------

def _star_queries(fg, per_class=6):
    qs = []
    for cid, t in sorted(fg.tables.items()):
        for row in t.objects[:per_class]:
            qs.append(StarQuery(arms=tuple(
                (int(p), int(o)) for p, o in zip(t.props, row)),
                class_id=cid))
            qs.append(StarQuery(arms=((int(t.props[0]), int(row[0])),
                                      (int(t.props[-1]), None)),
                                class_id=cid))
        qs.append(StarQuery(arms=((int(t.props[0]), None),), class_id=None))
        qs.append(StarQuery(arms=((int(t.props[0]), int(t.objects[0, 0])),
                                  (int(t.props[-1]), None)), class_id=None))
    return qs


def _same(a, b):
    assert np.asarray(a.subjects).tolist() == np.asarray(b.subjects).tolist()
    assert tuple(a.var_props) == tuple(b.var_props)
    assert np.asarray(a.var_objects).tolist() == \
        np.asarray(b.var_objects).tolist()


@pytest.fixture(scope="module")
def S(R):
    """A sensor graph partitioned into 3 shards and detected on the host
    by both packages, with the replicated compaction of each."""
    ref, port = _pair(R)
    jsnap, _ = R.Planner("gfsp", "host").run(ref.copy())
    snap, _ = CompactionPlanner("gfsp", "host").run(port.copy())
    jsh = R.graph.ShardedFactorizedGraph.partition(ref, 3)
    jsh.detect_all(backend="host")
    sh = ShardedFactorizedGraph.partition(port, 3)
    sh.detect_all(backend="host")
    return types.SimpleNamespace(ref=ref, port=port, jsnap=jsnap, snap=snap,
                                 jsh=jsh, sh=sh)


def test_sharded_query_engine_star_and_batch_equal_jax(R, S):
    qs = _star_queries(S.snap.fgraph)
    jeng = R.graph.ShardedQueryEngine(S.jsh)
    eng = ShardedQueryEngine(S.sh, device="cpu")
    S.sh.traffic["query_bytes"] = S.jsh.traffic["query_bytes"] = 0
    for q in qs:
        got = eng.query(q)
        _same(got, jeng.query(q))
        assert got.same_as(eval_raw(S.port, q))
    for backend in ("host", "device"):
        got = eng.query_batch(qs, backend=backend)
        want = jeng.query_batch(qs, backend=backend)
        for a, b in zip(got, want):
            _same(a, b)
    assert S.sh.traffic == S.jsh.traffic
    assert S.sh.traffic["query_bytes"] > 0


def test_sharded_bgp_equals_jax(R, S):
    d = S.port.dict
    obs, meas = d.lookup("ssn:Observation"), d.lookup("ssn:Measurement")
    t = S.snap.fgraph.tables[obs]
    p0, p1 = int(t.props[0]), int(t.props[-1])
    res = d.lookup("ssn:observationResult")
    val = d.lookup("ssn:value")
    shapes = [
        ((("?s", ((p0, "?v"), (p1, "?w")), obs),), (("?v", "!=", -1),)),
        ((("?o", ((res, "?m"),), obs), ("?m", ((val, "?v"),), meas)),
         (("?v", ">=", int(S.snap.fgraph.tables[meas].objects[0, 0])),)),
        ((("?s", ((p0, "?v"),), None),), ()),       # a classless star
    ]
    eng = ShardedQueryEngine(S.sh, device="cpu")
    jeng = R.graph.ShardedQueryEngine(S.jsh)
    for stars, filters in shapes:
        q = BGPQuery(stars=tuple(StarPattern(*s) for s in stars),
                     filters=tuple(Filter(*f) for f in filters))
        jq = R.alg.BGPQuery(stars=tuple(R.alg.StarPattern(*s)
                                        for s in stars),
                            filters=tuple(R.alg.Filter(*f) for f in filters))
        for strategy in ("auto", "raw", "factorized"):
            for backend in ("host", "device"):
                got = eng.query_bgp(q, strategy=strategy, backend=backend)
                want = jeng.query_bgp(jq, strategy=strategy,
                                      backend="host")
                assert got.columns == want.columns
                assert got.rows.tolist() == want.rows.tolist()
        assert got.n_rows > 0
    assert S.sh.traffic == S.jsh.traffic


def test_sharded_engine_rebind_follows_a_swap(R):
    _, port = _pair(R)
    sh = ShardedFactorizedGraph.partition(port, 2)
    sh.detect_all(backend="host")
    eng = ShardedQueryEngine(sh, device="cpu")
    fg = next(s.fgraph for s in sh.snapshots if s.fgraph.tables)
    q = _star_queries(fg, per_class=1)[0]
    before = eng.query(q)
    CompactionPlanner("gfsp", "host").redetect(
        None, [int(c) for c in port.classes()], sharded_graph=sh)
    eng.rebind()
    for e, s in zip(eng.engines, sh.snapshots):
        assert e.fgraph is s.fgraph and e.epoch == s.epoch
    assert eng.query(q).same_as(before)


# ---------------------------------------------------------------------------
# the sharded query service
# ---------------------------------------------------------------------------

def _term_requests(fg, d):
    reqs = []
    for cid, t in sorted(fg.tables.items()):
        cterm = d.term(cid)
        row = t.objects[0]
        reqs.append(dict(arms=tuple((d.term(int(p)), d.term(int(o)))
                                    for p, o in zip(t.props, row)),
                         class_term=cterm))
        reqs.append(dict(arms=((d.term(int(t.props[0])), None),),
                         class_term=cterm))
        reqs.append(dict(arms=((d.term(int(t.props[0])), None),),
                         class_term=None))          # coordinator
        reqs.append(dict(arms=((d.term(int(t.props[0])),
                                d.term(int(row[0]))),
                               (d.term(int(t.props[-1])), None)),
                         class_term=cterm, strategy="raw"))
    reqs += [dict(arms=((d.term(int(t.props[0])), None),),
                  class_term="ssn:Nope"),
             dict(arms=(("ssn:nope", None),), class_term=None)]
    bgps = [dict(stars=(("?s", ((d.term(int(t.props[0])), "?v"),),
                         d.term(cid)),)),
            dict(stars=(("?o", (("ssn:observationResult", "?m"),),
                         "ssn:Observation"),
                        ("?m", (("ssn:value", "?v"),),
                         "ssn:Measurement"))),
            dict(stars=(("?s", (("ssn:nope", "?v"),), None),))]
    return reqs, bgps


def _submit(svc, ns, reqs, bgps):
    for rid, r in enumerate(reqs):
        assert svc.submit(ns.GraphQueryRequest(rid=rid, **r))
    for rid, r in enumerate(bgps, start=len(reqs)):
        assert svc.submit(ns.BGPQueryRequest(rid=rid, **r))


_NS = types.SimpleNamespace(GraphQueryRequest=GraphQueryRequest,
                            BGPQueryRequest=BGPQueryRequest)


def _wave(out):
    return {rid: dataclasses.asdict(r) for rid, r in out.items()}


@pytest.mark.parametrize("backend", ["host", "device"])
def test_sharded_service_equals_jax_and_the_replicated_service(R, S,
                                                               backend):
    reqs, bgps = _term_requests(S.snap.fgraph, S.port.dict)
    jsvc = R.serving.ShardedQueryService(S.jsh, backend="host")
    svc = ShardedQueryService(S.sh, backend=backend, device="cpu")
    _submit(jsvc, R.serving, reqs, bgps)
    _submit(svc, _NS, reqs, bgps)
    assert svc.queue and any(s.queue for s in svc.shards)
    got, want = _wave(svc.run()), _wave(jsvc.run())
    assert got == want
    assert all(r["status"] == "ok" for r in got.values())
    assert S.sh.traffic == S.jsh.traffic
    m = svc.metrics.summary()
    for ch in ("admission.shed", "wave.deadline_shed", "wave.raw_fallback"):
        assert m[ch]["count"] == 0, ch
    # Def. 4.10: the replicated endpoint gives the same binding sets
    ref = GraphQueryService(S.snap.fgraph, backend=backend, device="cpu")
    _submit(ref, _NS, reqs, bgps)
    rep = ref.run()
    for rid, r in rep.items():
        a = got[rid]
        if "subjects" in a:
            assert sorted(zip(a["subjects"], a["var_objects"])) == \
                sorted(zip(r.subjects, r.var_objects)), rid
        else:
            assert sorted(a["rows"]) == sorted(r.rows), rid


def test_sharded_service_defaults_to_the_card(monkeypatch, S):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedQueryService(S.sh)
    svc = ShardedQueryService(S.sh, backend="host")
    assert svc.backend == "host"


def test_sharded_service_admission_is_all_or_nothing(R):
    _, port = _pair(R, 400)
    sh = ShardedFactorizedGraph.partition(port, 4, oversplit=4)
    sh.detect_all(backend="host")
    assert sh.plan.split_classes
    svc = ShardedQueryService(sh, backend="device", device="cpu",
                              max_pending=1)
    d = port.dict
    cid = sh.plan.split_classes[0]
    owners = sh.plan.shards_for_class(cid)
    assert len(owners) > 1
    t = sh.snapshots[owners[0]].fgraph.tables[int(cid)]
    mk = lambda rid: GraphQueryRequest(          # noqa: E731
        rid=rid, arms=((d.term(int(t.props[0])), None),),
        class_term=d.term(int(cid)))
    assert svc.submit(mk(0))               # fills every owner queue
    assert not svc.submit(mk(1))           # ANY full owner -> whole shed
    assert all(all(r.rid != 1 for r in s.queue) for s in svc.shards)
    assert svc.metrics.summary()["admission.shed"]["count"] == 1
    classless = GraphQueryRequest(rid=2, arms=((d.term(int(t.props[0])),
                                                None),))
    assert svc.submit(classless)
    assert not svc.submit(dataclasses.replace(classless, rid=3))
    out = svc.run()
    assert out[0].status == "ok" and out[2].status == "ok"
    assert out[0].n_rows == port.class_stats(int(cid)).n_instances


def test_sharded_service_coordinator_deadline_sheds(S):
    star = ("?s", (("ssn:observationResult", "?v"),), "ssn:Observation")
    svc = ShardedQueryService(S.sh, backend="device", device="cpu")
    assert svc.submit(BGPQueryRequest(rid=9, stars=(star,)))
    assert svc.queue and not any(s.queue for s in svc.shards)
    out = svc.run()
    assert out[9].status == "ok" and out[9].n_rows > 0
    tick = iter([0.0, 10.0, 20.0, 30.0])
    svc2 = ShardedQueryService(S.sh, backend="device", device="cpu",
                               wave_deadline_s=0.5,
                               clock=lambda: next(tick))
    assert svc2.submit(BGPQueryRequest(rid=1, stars=(star,)))
    assert svc2.submit(GraphQueryRequest(
        rid=2, arms=(("ssn:observationResult", None),)))
    out2 = svc2.run()
    assert out2[1].status == "shed" and out2[2].status == "shed"
    assert svc2.metrics.summary()["wave.deadline_shed"]["count"] == 2


def _boom(*a, **k):
    raise RuntimeError("sig_hash launch failed: cudaError_t 700")


def test_a_device_failure_raises_from_run(S):
    reqs, bgps = _term_requests(S.snap.fgraph, S.port.dict)
    # at the coordinator (a BGP and a classless star)
    for attr, req in (("query_bgp", BGPQueryRequest(rid=0, **bgps[0])),
                      ("query", GraphQueryRequest(rid=0, **reqs[2]))):
        svc = ShardedQueryService(S.sh, backend="device", device="cpu")
        setattr(svc.coordinator, attr, _boom)
        assert svc.submit(req)
        with pytest.raises(RuntimeError, match="cudaError_t 700"):
            svc.run()
    # in one shard's thread of the parallel drain
    svc = ShardedQueryService(S.sh, backend="device", device="cpu")
    owner = svc._owners(GraphQueryRequest(rid=0, **reqs[0]))[0]
    svc.shards[owner].engine.query_batch = _boom
    assert svc.submit(GraphQueryRequest(rid=0, **reqs[0]))
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        svc.run()


def test_the_host_backend_falls_back_as_jax_does(R, S):
    reqs, bgps = _term_requests(S.snap.fgraph, S.port.dict)
    outs = []
    for mod, sh, ns in ((R.serving, S.jsh, R.serving),
                        (None, S.sh, _NS)):
        svc = (mod.ShardedQueryService(sh, backend="host") if mod
               else ShardedQueryService(sh, backend="host"))
        svc.coordinator.query_bgp = _boom
        svc.coordinator.query = _boom
        _submit(svc, ns, [reqs[2]], [bgps[1]])
        out = svc.run()
        assert {r.status for r in out.values()} == {"degraded"}
        assert svc.metrics.summary()["wave.raw_fallback"]["count"] == 2
        outs.append(_wave(out))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# a shard's durable worker killed, recovered and swapped back in
# ---------------------------------------------------------------------------

_SVC_KW = dict(detector="gfsp", backend="host", raw_residue_threshold=4,
               support_drift_threshold=3, retry_sleep=lambda _: None)

_SHARD_WORKER = """\
import json, sys
from repro_torch.data.synthetic import SensorGraphSpec, generate
from repro_torch.dist.fault import FaultPlan
from repro_torch.dist.graph import ShardedFactorizedGraph
from repro_torch.online import OnlineCompactionService

root, sid, batches_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
store = generate(SensorGraphSpec(n_observations=40, seed=5))
sharded = ShardedFactorizedGraph.partition(store, 3)
sub = sharded.snapshots[sid].fgraph.store
svc = OnlineCompactionService.durable(
    root, sub, checkpoint_every=3, checkpoint_async=False,
    detector="gfsp", backend="host", raw_residue_threshold=4,
    support_drift_threshold=3, retry_sleep=lambda _: None,
    fault_plan=FaultPlan("apply", occurrence=4, mode="kill"))
with open(batches_path) as f:
    batches = json.load(f)
for ins, dels in batches:
    svc.submit(inserts=[tuple(t) for t in ins], delete_entities=dels)
    svc.drain()
print("SURVIVED")          # the armed kill must preempt this line
"""


def _novel_batches(store, n):
    """Term-level batches of complete typed entities with novel objects,
    every third deleting an earlier insert (the drift-heavy shape)."""
    term = store.dict.term
    cid = int(store.classes()[0])
    props = np.asarray(store.class_properties(cid))
    cterm, tterm = term(cid), term(store.TYPE)
    pterms = [term(int(p)) for p in props]
    out = []
    for i in range(n):
        ins = []
        for j in range(3):
            s = f"e:n/b{i}/{j}"
            ins.append((s, tterm, cterm))
            ins += [(s, p, f"o:novel/b{i}/{j}/{k}")
                    for k, p in enumerate(pterms)]
        dels = [f"e:n/b{i - 2}/0"] if i % 3 == 2 else None
        out.append((ins, dels))
    return out


def test_a_killed_shard_recovers_and_swaps_back(tmp_path):
    store = generate(SensorGraphSpec(n_observations=40, seed=5))
    sharded = ShardedFactorizedGraph.partition(store, 3)
    sid = sharded.plan.shards_for_class(int(store.classes()[0]))[0]
    batches = _novel_batches(store, 8)
    bpath = tmp_path / "batches.json"
    bpath.write_text(json.dumps(batches))
    root = tmp_path / "shard_root"
    script = tmp_path / "worker.py"
    script.write_text(_SHARD_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(script), str(root), str(sid), str(bpath)],
        cwd=ROOT, env=env, capture_output=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()
    assert b"SURVIVED" not in proc.stdout

    # the uninterrupted twin over the same sub-store mints first, so its
    # novel terms take the ids the dead worker journaled
    twin_sub = TripleStore.from_ids(
        store.dict, sharded.snapshots[sid].fgraph.store.spo.copy(),
        presorted=True)
    twin = OnlineCompactionService(twin_sub, **_SVC_KW)
    for ins, dels in batches:
        twin.submit(inserts=ins, delete_entities=dels)
        twin.drain()

    svc = recover(str(root), **_SVC_KW)
    assert svc.last_recovery is not None
    assert svc.last_recovery.checkpoint_bytes > 0
    svc.drain()
    applied = svc.applied_seq + 1
    assert 0 < applied < len(batches)      # it really died mid-soak
    for ins, dels in batches[applied:]:
        svc.submit(inserts=ins, delete_entities=dels)
        svc.drain()
    svc.close()
    assert svc.queue.depth == 0
    assert svc.snapshot.digest() == twin.snapshot.digest()

    # one atomic tuple store, and the whole sharded graph matches the
    # never-interrupted twin world
    other = ShardedFactorizedGraph.partition(store, 3)
    before = sharded.snapshots
    sharded.swap_shard(sid, svc.snapshot)
    other.swap_shard(sid, twin.snapshot)
    assert sharded.snapshots is not before
    assert sharded.digest() == other.digest()
    eng = ShardedQueryEngine(sharded, device="cpu")
    q = StarQuery(arms=((int(store.class_properties(
        int(store.classes()[0]))[0]), None),),
        class_id=int(store.classes()[0]))
    assert eng.query(q).same_as(ShardedQueryEngine(
        other, device="cpu").query(q))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

_MS = ("replicated_ms", "sharded_ms")


@pytest.mark.parametrize("backend", ["host", "device"])
def test_serve_sharded_queries_equals_jax(R, backend, capsys):
    want = R.serve.serve_sharded_queries(24, n_shards=4)
    got = serve.serve_sharded_queries(24, n_shards=4, backend=backend,
                                      device="cpu")
    assert {k: v for k, v in got.items() if k not in _MS} == \
        {k: v for k, v in want.items() if k not in _MS}
    assert all(got[k] > 0 for k in _MS)
    assert "sharded endpoint" in capsys.readouterr().out


def test_the_sharded_mode_parses_and_defaults_to_the_card(monkeypatch):
    seen = {}
    monkeypatch.setattr(serve, "serve_sharded_queries",
                        lambda n, **kw: seen.update(n=n, **kw) or seen)
    serve.main(["--sharded", "3"])
    assert seen == {"n": 24, "n_shards": 3, "seed": 0, "backend": "device",
                    "device": "cuda"}
    serve.main(["--sharded", "2", "--graph-queries", "30", "--device",
                "cpu", "--graph-backend", "host"])
    assert seen["n"] == 30 and seen["device"] == "cpu"


def test_serve_sharded_queries_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve_sharded_queries(6, n_shards=2, n_observations=40)
