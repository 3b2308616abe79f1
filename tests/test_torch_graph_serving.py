"""The port's graph-query server against the JAX package's on the same
snapshots: ``GraphQueryService`` answering star and BGP requests (term
misses included), shedding a full admission queue, shedding a wave past
its deadline under a fake clock, counting the raw fallback when the
factorized path fails, following a live ``OnlineCompactionService``
across a swap; the result dicts of ``serve_graph_queries``,
``serve_bgp_queries`` and ``serve_online``; and ``--online --durable
--chaos`` killed and restarted in a subprocess.

The reference is imported inside the ``R`` fixture (it pulls in jax), so
on a machine without jax every comparison skips."""
import dataclasses
import os
import signal
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import pytest
import torch

from repro_torch.api import Compactor, GraphSnapshot
from repro_torch.convert import store_from_arrays
from repro_torch.data.synthetic import (MEASUREMENT, OBSERVATION, P_MODEL,
                                        P_PROCEDURE, P_RESULT, P_TIME,
                                        P_VALUE, SENSOR)
from repro_torch.launch import serve
from repro_torch.online import OnlineCompactionService
from repro_torch.serving import (BGPQueryRequest, GraphQueryRequest,
                                 GraphQueryResponse, GraphQueryService)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    import repro.launch.serve as jserve
    import repro.online as online
    import repro.serving as serving
    from repro.api import Compactor as JCompactor
    from repro.data import synthetic as syn
    return types.SimpleNamespace(serve=jserve, online=online,
                                 serving=serving, Compactor=JCompactor,
                                 syn=syn)


def _pair(R, n=80, seed=3, metadata=True):
    ref = R.syn.generate(R.syn.SensorGraphSpec(
        n_observations=n, seed=seed, include_sensor_metadata=metadata))
    return ref, store_from_arrays(list(ref.dict._terms), ref.spo)


@pytest.fixture(scope="module")
def G(R):
    """One sensor graph compacted by both packages."""
    ref, store = _pair(R)
    jc = R.Compactor(detector="gfsp", backend="host")
    jc.run(ref)
    tc = Compactor("gfsp", "host")
    tc.run(store)
    assert tc.snapshot.digest() == jc.snapshot.digest()
    return types.SimpleNamespace(jfg=jc.fgraph, tfg=tc.fgraph,
                                 term=store.dict.term)


def _requests(G):
    """Star requests of ``serve_graph_queries``'s four kinds and the
    strategies, BGP requests of every shape, and term misses."""
    term = G.term
    reqs = []
    for cid, t in sorted(G.tfg.tables.items()):
        row = t.objects[0]
        for strategy in ("factorized", "raw"):
            for arms in (
                    tuple((term(p), term(int(o)))
                          for p, o in zip(t.props, row)),
                    ((term(t.props[0]), term(int(row[0]))),
                     (term(t.props[-1]), None)),
                    ((term(t.props[0]), term(int(row[-1]))),),
                    ((term(t.props[0]), None),)):
                reqs.append(dict(arms=arms, class_term=term(cid),
                                 strategy=strategy))
    reqs += [dict(arms=((P_TIME, "time/3"),), class_term=None),
             dict(arms=((P_TIME, "time/nope"),), class_term=OBSERVATION),
             dict(arms=((P_TIME, None),), class_term="ssn:Nope"),
             dict(arms=(("ssn:nope", None),), class_term=OBSERVATION)]
    bgps = []
    for strategy in ("auto", "raw", "factorized"):
        bgps += [
            dict(stars=(("?o", ((P_PROCEDURE, "?s"), (P_TIME, "time/3")),
                         OBSERVATION),
                        ("?s", ((P_MODEL, "model/1"),), SENSOR)),
                 strategy=strategy),
            dict(stars=(("?o", ((P_PROCEDURE, "?s"), (P_RESULT, "?m")),
                         OBSERVATION),
                        ("?s", ((P_MODEL, "model/0"),), SENSOR),
                        ("?m", ((P_VALUE, "?v"),), MEASUREMENT)),
                 filters=(("?v", "<", "val/6"),), strategy=strategy),
            dict(stars=(("?m", ((P_VALUE, "?v"),), MEASUREMENT),),
                 filters=(("?v", "==", "val/1"),), strategy=strategy)]
    bgps += [dict(stars=(("?m", ((P_VALUE, "val/nope"),), MEASUREMENT),)),
             dict(stars=(("?m", ((P_VALUE, "?v"),), MEASUREMENT),),
                  filters=(("?v", ">=", "val/nope"),)),
             dict(stars=(("?m", ((P_VALUE, "?v"),), "ssn:Nope"),))]
    return reqs, bgps


def _submit_all(svc, ns, reqs, bgps):
    for rid, r in enumerate(reqs):
        assert svc.submit(ns.GraphQueryRequest(rid=rid, **r))
    for rid, r in enumerate(bgps, start=len(reqs)):
        assert svc.submit(ns.BGPQueryRequest(rid=rid, **r))


def _same_wave(jout, tout):
    assert set(tout) == set(jout)
    for rid in jout:
        assert type(tout[rid]).__name__ == type(jout[rid]).__name__, rid
        assert dataclasses.asdict(tout[rid]) == \
            dataclasses.asdict(jout[rid]), rid


def _channels(svc):
    return {k: (v["count"], v["total"])
            for k, v in svc.metrics.summary().items()}


@pytest.mark.parametrize("backend", ["host", "device"])
def test_wave_matches_reference(G, R, backend):
    """Every response -- subjects and objects in order, variables, rows,
    the planner's strategies, status -- equals the reference's."""
    reqs, bgps = _requests(G)
    jsvc = R.serving.GraphQueryService(G.jfg, backend="host")
    tsvc = GraphQueryService(G.tfg, backend=backend, device="cpu")
    _submit_all(jsvc, R.serving, reqs, bgps)
    _submit_all(tsvc, types.SimpleNamespace(
        GraphQueryRequest=GraphQueryRequest,
        BGPQueryRequest=BGPQueryRequest), reqs, bgps)
    jout, tout = jsvc.run(), tsvc.run()
    _same_wave(jout, tout)
    assert all(r.status == "ok" for r in tout.values())
    assert sum(r.n_rows > 0 for r in tout.values()) > len(tout) // 2
    misses = [rid for rid in tout if tout[rid].n_rows == 0]
    assert len(misses) >= 7
    assert _channels(tsvc) == _channels(jsvc)
    assert tsvc.run() == {}


def test_admission_shed_on_full_queue(G, R):
    outs = []
    for ns, fg in ((R.serving, G.jfg), (None, G.tfg)):
        svc = (GraphQueryService(fg, max_pending=2) if ns is None
               else ns.GraphQueryService(fg, max_pending=2))
        mk = (GraphQueryRequest if ns is None else ns.GraphQueryRequest)
        reqs, _ = _requests(G)
        acc = [svc.submit(mk(rid=rid, **reqs[rid])) for rid in range(3)]
        assert acc == [True, True, False]
        out = svc.run()
        assert set(out) == {0, 1}
        assert svc.submit(mk(rid=3, **reqs[3]))     # admission resumes
        outs.append((out, _channels(svc)))
    _same_wave(outs[0][0], outs[1][0])
    assert outs[1][1] == outs[0][1]
    assert outs[1][1]["admission.shed"] == (1, 1.0)


@pytest.mark.parametrize("budget", [5.0, 25.0])
def test_wave_deadline_sheds_explicitly(G, R, budget):
    """A fake clock that advances 10 per read: with a budget of 5 every
    request sheds, with 25 the two BGP requests are answered and the
    three star requests shed -- the same responses and counts in both
    packages."""
    reqs, bgps = _requests(G)
    outs = []
    for ns, fg, cls in ((R.serving, G.jfg, R.serving.GraphQueryService),
                        (None, G.tfg, GraphQueryService)):
        tick = [0.0]

        def clock():
            tick[0] += 10.0
            return tick[0]

        svc = cls(fg, wave_deadline_s=budget, clock=clock)
        _submit_all(svc, ns or types.SimpleNamespace(
            GraphQueryRequest=GraphQueryRequest,
            BGPQueryRequest=BGPQueryRequest), reqs[:3], bgps[:2])
        outs.append((svc.run(), _channels(svc)))
    _same_wave(outs[0][0], outs[1][0])
    assert outs[1][1] == outs[0][1]
    shed = [r for r in outs[1][0].values() if r.status == "shed"]
    assert len(outs[1][0]) == 5 and all(r.n_rows == 0 for r in shed)
    assert len(shed) == (5 if budget == 5.0 else 3)


def test_factorized_failure_falls_back_to_raw(G, R):
    """A dead batched path: every factorized star request of the wave is
    answered from the raw expansion, marked degraded, counted once with
    its request count; a dead BGP path falls back per request."""
    reqs, bgps = _requests(G)
    reqs = [r for r in reqs if r.get("strategy") == "factorized"][:4]
    outs = []
    for ns, fg, cls in ((R.serving, G.jfg, R.serving.GraphQueryService),
                        (None, G.tfg, GraphQueryService)):
        svc = cls(fg)

        def boom(*a, **k):
            raise RuntimeError("device lost")

        orig = svc.engine.query_bgp
        tried = []

        def flaky(q, *, strategy, backend, return_stats, orig=orig,
                  tried=tried):
            tried.append(strategy)
            if strategy != "raw":
                raise RuntimeError("kernel fault")
            return orig(q, strategy=strategy, backend="host",
                        return_stats=return_stats)

        svc.engine.query_batch = boom
        svc.engine.query_bgp = flaky
        _submit_all(svc, ns or types.SimpleNamespace(
            GraphQueryRequest=GraphQueryRequest,
            BGPQueryRequest=BGPQueryRequest), reqs, bgps[:1])
        outs.append((svc.run(), _channels(svc), tried))
    _same_wave(outs[0][0], outs[1][0])
    assert outs[1][1] == outs[0][1]
    assert outs[1][1]["wave.raw_fallback"] == (2, 5.0)
    assert outs[1][2] == outs[0][2] == ["auto", "raw"]
    assert all(r.status == "degraded" for r in outs[1][0].values())
    assert all(r.strategy == "raw" for r in outs[1][0].values()
               if isinstance(r, GraphQueryResponse))


@pytest.mark.parametrize("path", ["star", "bgp"])
def test_device_failure_raises(G, path):
    """On the device backend a failure of the factorized path is not
    answered by the host: the wave raises and nothing is counted as a
    fallback."""
    reqs, bgps = _requests(G)
    svc = GraphQueryService(G.tfg, backend="device", device="cpu")

    def boom(*a, **k):
        raise RuntimeError("kernel fault")

    if path == "star":
        svc.engine.query_batch = boom
        svc.submit(GraphQueryRequest(rid=0, **reqs[0]))
    else:
        svc.engine.query_bgp = boom
        svc.submit(BGPQueryRequest(rid=0, **bgps[0]))
    with pytest.raises(RuntimeError, match="kernel fault"):
        svc.run()
    assert svc.metrics.summary()["wave.raw_fallback"]["count"] == 0


def test_device_backend_without_cuda_raises(G):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GraphQueryService(G.tfg, backend="device")
    GraphQueryService(G.tfg, backend="host")      # host needs no card


def _online_batch(store, tag, n=3):
    term = store.dict.term
    cid = int(store.classes()[0])
    _, mat = store.object_matrix(cid, store.class_properties(cid))
    pterms = [term(int(p)) for p in store.class_properties(cid)]
    ins = []
    for j in range(n):
        s = f"e:live/{tag}/{j}"
        ins.append((s, term(store.TYPE), term(cid)))
        ins += [(s, p, term(int(o))) for p, o in zip(pterms, mat[j])]
    return ins, [(p, None) for p in pterms[:1]], term(cid)


@pytest.mark.parametrize("handle", ["service", "callable", "snapshot"])
def test_live_service_handle_across_a_swap(R, handle):
    """A service over a live ``OnlineCompactionService`` serves each wave
    from the snapshot current at its start; after an ingest swap the
    next wave sees the new epoch and the new entities, as the
    reference's does."""
    ref, store = _pair(R, n=60, seed=8, metadata=False)
    kw = dict(detector="gfsp", backend="host", retry_sleep=lambda _: None)
    jlive = R.online.OnlineCompactionService(ref, **kw)
    tlive = OnlineCompactionService(store, **kw)
    src = {"service": (jlive, tlive),
           "callable": (lambda: jlive.snapshot, lambda: tlive.snapshot),
           "snapshot": (jlive.snapshot, tlive.snapshot)}[handle]
    jsvc = R.serving.GraphQueryService(src[0])
    tsvc = GraphQueryService(src[1])
    assert tsvc.epoch == jsvc.epoch == 0
    ins, arms, cterm = _online_batch(store, "a")
    outs = []
    for step in range(2):
        for svc, ns in ((jsvc, R.serving), (tsvc, None)):
            mk = GraphQueryRequest if ns is None else ns.GraphQueryRequest
            svc.submit(mk(rid=0, arms=arms, class_term=cterm))
            svc.submit(mk(rid=1, arms=((P_TIME, None),),
                          class_term=OBSERVATION, strategy="raw"))
        outs.append((jsvc.run(), tsvc.run()))
        _same_wave(*outs[-1])
        jlive.submit(inserts=ins)
        jlive.drain()
        tlive.submit(inserts=ins)
        tlive.drain()
        assert tlive.snapshot.digest() == jlive.snapshot.digest()
    new = {f"e:live/a/{j}" for j in range(3)}
    before = set(outs[0][1][0].subjects)
    after = set(outs[1][1][0].subjects)
    if handle == "snapshot":            # pinned: never sees the swap
        assert tsvc.epoch == 0 and after == before
    else:
        assert tsvc.engine.epoch == jsvc.engine.epoch > 0
        assert after - before == new
    assert isinstance(tsvc._resolve(), GraphSnapshot)


def _strip_times(d):
    """A result dict without its times (keys ending in ``_ms``, and the
    metrics channels' accumulated values beside their counts)."""
    if isinstance(d, dict):
        return {k: _strip_times(v) for k, v in d.items()
                if not k.endswith("_ms") and k not in
                ("last", "total", "min", "max", "mean")}
    if isinstance(d, list):
        return [_strip_times(x) for x in d]
    return d


@pytest.mark.parametrize("name,kw", [
    ("serve_graph_queries", dict(n_requests=64)),
    ("serve_bgp_queries", dict(n_requests=24)),
    ("serve_online", dict(n_batches=20))])
@pytest.mark.parametrize("backend", ["host", "device"])
def test_entry_points_match_reference(R, name, kw, backend):
    want = getattr(R.serve, name)(**kw, backend="host")
    got = getattr(serve, name)(**kw, backend=backend, device="cpu")
    assert _strip_times(got) == _strip_times(want)
    assert set(got) == set(want)


def test_main_routes_the_graph_modes(R):
    got = serve.main(["--bgp", "6", "--device", "cpu"])
    assert _strip_times(got) == _strip_times(
        R.serve.serve_bgp_queries(6, backend="host"))
    got = serve.main(["--graph-queries", "8", "--graph-backend", "host"])
    assert _strip_times(got) == _strip_times(
        R.serve.serve_graph_queries(8, backend="host"))


@pytest.mark.parametrize("argv", [["--graph-queries", "8"], ["--bgp", "6"],
                                  ["--online", "--online-batches", "2"]])
def test_graph_modes_default_to_the_card(argv):
    """Every graph mode runs on the device backend on ``cuda`` unless the
    caller asks for the CPU: without CUDA it refuses to start."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(argv)


def test_online_chaos_kill_and_restart():
    """``--online --durable DIR --chaos 0`` on the host backend dies by
    SIGKILL at its seeded fault site; the same command again recovers
    from DIR and passes its gates (digest parity with a from-scratch
    compaction of the recovered graph)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as root:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--online",
               "--durable", root, "--chaos", "0", "--graph-backend", "host"]
        first = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=120, cwd=ROOT)
        assert first.returncode == -signal.SIGKILL, first.stderr
        again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=120, cwd=ROOT)
        assert again.returncode == 0, again.stderr
        last = again.stdout.strip().splitlines()[-1]
        assert last.startswith("online soak (recovery)"), last
        assert "gates PASS" in last
