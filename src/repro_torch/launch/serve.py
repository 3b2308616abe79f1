"""Serving launcher: batched LM requests through the factorized-prefix
Engine, or star and BGP queries on a compacted RDF graph.

The port of ``repro/launch/serve.py``.  The LM mode: requests that share
a system prompt get the shared prefix prefilled once per distinct prefix
(compact molecule), per-request suffixes attach via the instanceOf
pointer, and every prefix policy must produce the same tokens.

    python -m repro_torch.launch.serve --arch mamba2-780m \\
        --reduced --device cpu             # the plain-torch path
    python -m repro_torch.launch.serve     # qwen2-0.5b, full width, on the card

``--arch`` takes every config of ``configs.ARCHS`` (the hybrid
recurrentgemma-2b, the dense qwen2-0.5b, llama3.2-1b, qwen3-32b and
llama3-405b, the SSM mamba2-780m, the MoE moonshot-v1-16b-a3b and
dbrx-132b, the encoder-decoder whisper-medium and the VLM internvl2-2b)
and defaults to qwen2-0.5b, as the JAX launcher does.  The weights are
random, drawn from a ``torch.Generator`` seeded with ``--seed``.
``--reduced`` is the tiny float32 config: the JAX launcher's
``reduced(cfg)`` on the CPU, and the same at head_dim 64 on the card,
where no flash kernel is built at JAX's head_dim 32
(:func:`repro_torch.launch.arch_config`, shared with ``launch.train``).
The JAX launcher's ``--reduced`` cannot be turned off (its default is
true), so ``repro.launch.serve --arch X`` always serves the reduced
config where this launcher serves the published one.
In float32 (``--reduced``) the policies' tokens are asserted identical;
in bf16 an argmax over near-tied logits may differ, so there the share
of agreeing tokens is printed instead.  whisper-medium and internvl2-2b
take the frontend stub's embeddings, which ``Engine`` requests do not
carry: they are served through ``train.serve_step`` (a prefill with
seeded ``frontend_embeds``, then greedy decode steps), without prefix
policies.

The graph modes serve the other side of the paper.  ``--graph-queries
N`` answers N star queries on a compacted sensor graph through
``serving.GraphQueryService`` under the ``factorized`` and ``raw``
strategies (binding sets asserted identical); ``--bgp N`` answers N
multi-star BGPs (joins over ``procedure``/``observationResult``,
pushed-down value filters) under the planner and both fixed strategies;
``--sharded N`` partitions the graph into N shards, detects shard-local
and serves a wave of star queries through ``ShardedQueryService``
against the replicated endpoint (binding sets asserted identical);
``--online`` soaks the online compaction service and gates its
guarantees (``--durable DIR`` journals and checkpoints under DIR, and
recovers when DIR already holds state; ``--chaos SEED`` arms a seeded
SIGKILL on a fresh durable run).  ``--graph-backend`` picks the
compaction sweep and molecule-match backend of every graph mode
(default ``device``; ``host`` is the numpy path); ``--device`` is where
the ``device`` backend runs (default ``cuda``), so without a card the
graph modes need ``--device cpu`` or ``--graph-backend host``:

    python -m repro_torch.launch.serve --graph-queries 64 --device cpu
    python -m repro_torch.launch.serve --bgp 24 --device cpu
    python -m repro_torch.launch.serve --sharded 4 --device cpu
    python -m repro_torch.launch.serve --online --durable DIR --chaos 0
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCHS
from ..kernels.ops import resolve_device
from ..models.lm import LM
from ..serving import (PREFIX_POLICIES, BGPQueryRequest, Engine,
                       GraphQueryRequest, GraphQueryService, Request)
from ..train.serve_step import make_decode_step, make_prefill_step
from . import REDUCED_HELP, arch_config


def _graph_backend(backend: str, device):
    """The compaction backend of a graph mode: ``"host"``, or the device
    sweeps on ``device``."""
    from ..api import DeviceBackend
    return DeviceBackend(device=device) if backend == "device" else backend


def _run_wave(svc, reqs) -> tuple[dict, float]:
    """Submits ``reqs`` to ``svc`` and runs them as one wave; returns the
    responses and the wave's ms.  Every request must be admitted and
    answered ``"ok"``: a degraded or shed answer fails the run."""
    for r in reqs:
        assert svc.submit(r), f"request {r.rid} was shed at admission"
    t0 = time.perf_counter()
    out = svc.run()
    ms = (time.perf_counter() - t0) * 1e3
    bad = {rid: r.status for rid, r in out.items() if r.status != "ok"}
    assert not bad, f"responses not ok: {bad}"
    m = svc.metrics.summary()
    for ch in ("admission.shed", "wave.deadline_shed", "wave.raw_fallback"):
        assert m[ch]["count"] == 0, f"{ch}: {m[ch]}"
    return out, ms


def serve_graph_queries(n_requests: int, *, n_observations: int = 600,
                        seed: int = 0, backend: str = "device",
                        device="cuda") -> dict:
    """Compact a sensor graph and serve star queries over G'.

    ``backend="device"`` compacts and matches molecules on ``device``
    (default ``"cuda"``: the hand kernels; without CUDA it raises).
    Every response must be ``"ok"``, with nothing shed or answered by
    the raw fallback."""
    from ..api import Compactor
    from ..data.synthetic import SensorGraphSpec, generate

    store = generate(SensorGraphSpec(n_observations=n_observations,
                                     seed=seed))
    comp = Compactor(detector="gfsp", backend=_graph_backend(backend, device))
    comp.run(store)
    fg = comp.fgraph
    term = store.dict.term
    rng = np.random.default_rng(seed)

    reqs = []
    classes = list(fg.tables.items())
    for i in range(n_requests):
        cid, t = classes[i % len(classes)]
        row = t.objects[int(rng.integers(0, t.n_molecules))]
        kind = i % 4
        if kind == 0:       # full molecule lookup (all arms ground)
            arms = tuple((term(p), term(int(o)))
                         for p, o in zip(t.props, row))
        elif kind == 1:     # partial arms + one variable object
            arms = ((term(t.props[0]), term(int(row[0]))),
                    (term(t.props[-1]), None))
        elif kind == 2:     # miss: an object term from another column
            arms = ((term(t.props[0]), term(int(row[-1]))),)
        else:               # unconstrained variable scan over one arm
            arms = ((term(t.props[0]), None),)
        reqs.append((arms, term(cid)))

    results = {}
    timings = {}
    for strategy in ("raw", "factorized"):
        svc = GraphQueryService(fg, backend=backend, device=device)
        # the raw baseline queries the expanded graph: build it outside
        # the timer so the printed latency is query time, not expansion
        svc.engine.raw_store
        results[strategy], timings[strategy] = _run_wave(svc, [
            GraphQueryRequest(rid=rid, arms=arms, class_term=cterm,
                              strategy=strategy)
            for rid, (arms, cterm) in enumerate(reqs)])
    for rid in range(len(reqs)):
        a = results["raw"][rid]
        b = results["factorized"][rid]
        assert sorted(a.subjects) == sorted(b.subjects), rid
        assert a.n_rows == b.n_rows, rid
    n_rows = sum(r.n_rows for r in results["raw"].values())
    print(f"graph-query endpoint: {len(reqs)} star queries, "
          f"{n_rows} bindings -- raw {timings['raw']:.1f} ms, "
          f"factorized {timings['factorized']:.1f} ms "
          f"(identical binding sets)")
    return {"n_requests": len(reqs), "n_rows": n_rows,
            "raw_ms": timings["raw"],
            "factorized_ms": timings["factorized"]}


def serve_bgp_queries(n_requests: int, *, n_observations: int = 600,
                      seed: int = 0, backend: str = "device",
                      device="cuda") -> dict:
    """Serve multi-star BGP queries through the cost-based BGP engine.

    Each request is a join-bearing BGP (observation-sensor over
    ``procedure``, observation-measurement over ``observationResult``,
    or a filtered single star); the wave runs once per strategy
    (``auto`` / ``raw`` / ``factorized``) and the binding sets are
    asserted identical -- the planner may pick a different per-star mix
    per query, but the answers cannot differ (Def. 4.10).
    ``backend`` and ``device`` as in :func:`serve_graph_queries`, and as
    there every response must be ``"ok"``.
    """
    from ..api import Compactor
    from ..data.synthetic import (MEASUREMENT, OBSERVATION, P_MODEL,
                                  P_PROCEDURE, P_RESULT, P_TIME, P_VALUE,
                                  SENSOR, SensorGraphSpec, generate)

    store = generate(SensorGraphSpec(n_observations=n_observations,
                                     seed=seed,
                                     include_sensor_metadata=True))
    comp = Compactor(detector="gfsp", backend=_graph_backend(backend, device))
    comp.run(store)
    fg = comp.fgraph
    rng = np.random.default_rng(seed)

    def make(rid: int) -> BGPQueryRequest:
        kind = rid % 3
        if kind == 0:       # obs-sensor molecule-to-molecule join
            stars = (("?o", ((P_PROCEDURE, "?s"),
                             (P_TIME, f"time/{rng.integers(0, 50)}")),
                      OBSERVATION),
                     ("?s", ((P_MODEL, f"model/{rng.integers(0, 3)}"),),
                      SENSOR))
            return BGPQueryRequest(rid=rid, stars=stars)
        if kind == 1:       # 3-star chain with a pushed-down filter
            stars = (("?o", ((P_PROCEDURE, "?s"), (P_RESULT, "?m")),
                      OBSERVATION),
                     ("?s", ((P_MODEL, f"model/{rng.integers(0, 3)}"),),
                      SENSOR),
                     ("?m", ((P_VALUE, "?v"),), MEASUREMENT))
            return BGPQueryRequest(
                rid=rid, stars=stars,
                filters=(("?v", "<", f"val/{rng.integers(2, 9)}"),))
        stars = (("?m", ((P_VALUE, "?v"),), MEASUREMENT),)
        return BGPQueryRequest(
            rid=rid, stars=stars,
            filters=(("?v", "==", f"val/{rng.integers(0, 6)}"),))

    reqs = [make(rid) for rid in range(n_requests)]
    results, timings = {}, {}
    for strategy in ("raw", "factorized", "auto"):
        svc = GraphQueryService(fg, backend=backend, device=device)
        svc.engine.raw_store    # build the baseline outside the timer
        results[strategy], timings[strategy] = _run_wave(
            svc, [dataclasses.replace(r, strategy=strategy) for r in reqs])
    planner_mix = {"raw": 0, "factorized": 0}
    for rid in range(n_requests):
        a, b, c = (results[s][rid] for s in ("raw", "factorized", "auto"))
        assert sorted(a.rows) == sorted(b.rows) == sorted(c.rows), rid
        for s in c.strategies:
            planner_mix[s] += 1
    n_rows = sum(r.n_rows for r in results["auto"].values())
    print(f"bgp endpoint: {n_requests} multi-star queries, "
          f"{n_rows} bindings -- raw {timings['raw']:.1f} ms, "
          f"factorized {timings['factorized']:.1f} ms, "
          f"planner {timings['auto']:.1f} ms "
          f"(identical binding sets; planner mix {planner_mix})")
    return {"n_requests": n_requests, "n_rows": n_rows,
            "raw_ms": timings["raw"],
            "factorized_ms": timings["factorized"],
            "auto_ms": timings["auto"], "planner_mix": planner_mix}


def serve_sharded_queries(n_requests: int, *, n_shards: int = 4,
                          n_observations: int = 600, seed: int = 0,
                          backend: str = "device", device="cuda") -> dict:
    """Serve star queries through the sharded fan-out path and assert
    binding-set parity with the replicated endpoint.

    Partitions the sensor graph across ``n_shards`` shards, runs
    shard-local detection, and drains the same request wave through a
    :class:`~repro_torch.serving.ShardedQueryService` (per-shard wave
    queues, parallel drain, concat merge) and a replicated
    :class:`~repro_torch.serving.GraphQueryService` over the unsharded
    compaction -- Def. 4.10 says the answers cannot differ, and the
    printed cross-shard traffic shows what the fan-out actually moved
    (binding sets only; molecule tables never leave their shard).
    ``backend`` and ``device`` as in :func:`serve_graph_queries`: both
    compactions and both services run there, and every response must be
    ``"ok"``.
    """
    from ..api import CompactionPlanner
    from ..data.synthetic import SensorGraphSpec, generate
    from ..dist.graph import ShardedFactorizedGraph
    from ..serving import ShardedQueryService

    store = generate(SensorGraphSpec(n_observations=n_observations,
                                     seed=seed))
    snap, _ = CompactionPlanner(
        "gfsp", _graph_backend(backend, device)).run(store.copy())
    sharded = ShardedFactorizedGraph.partition(store.copy(), n_shards)
    sharded.detect_all(backend=backend, device=device)
    assert sharded.digest() == snap.digest(), \
        "sharded detection broke digest parity"

    fg = snap.fgraph
    term = store.dict.term
    rng = np.random.default_rng(seed)
    reqs = []
    classes = list(fg.tables.items())
    for i in range(n_requests):
        cid, t = classes[i % len(classes)]
        row = t.objects[int(rng.integers(0, t.n_molecules))]
        if i % 3 == 0:      # full molecule lookup
            arms = tuple((term(p), term(int(o)))
                         for p, o in zip(t.props, row))
        elif i % 3 == 1:    # partial ground + variable object
            arms = ((term(t.props[0]), term(int(row[0]))),
                    (term(t.props[-1]), None))
        else:               # classless variable scan (coordinator path)
            reqs.append((((term(t.props[0]), None),), None))
            continue
        reqs.append((arms, term(cid)))

    results, timings = {}, {}
    for name, svc in (
            ("replicated", GraphQueryService(fg, backend=backend,
                                             device=device)),
            ("sharded", ShardedQueryService(sharded, backend=backend,
                                            device=device))):
        results[name], timings[name] = _run_wave(svc, [
            GraphQueryRequest(rid=rid, arms=arms, class_term=cterm)
            for rid, (arms, cterm) in enumerate(reqs)])
    for rid in range(len(reqs)):
        a, b = results["replicated"][rid], results["sharded"][rid]
        assert sorted(zip(a.subjects, a.var_objects)) \
            == sorted(zip(b.subjects, b.var_objects)), rid
    n_rows = sum(r.n_rows for r in results["sharded"].values())
    print(f"sharded endpoint: {len(reqs)} star queries over "
          f"{n_shards} shards, {n_rows} bindings -- replicated "
          f"{timings['replicated']:.1f} ms, sharded "
          f"{timings['sharded']:.1f} ms, cross-shard "
          f"{sharded.traffic['query_bytes']} B (identical binding sets)")
    return {"n_requests": len(reqs), "n_rows": n_rows,
            "n_shards": n_shards,
            "replicated_ms": timings["replicated"],
            "sharded_ms": timings["sharded"],
            "query_bytes": sharded.traffic["query_bytes"]}


def serve_online(n_batches: int = 20, *, n_observations: int = 80,
                 seed: int = 0, backend: str = "device", device="cuda",
                 assert_gates: bool = True, durable_root: str | None = None,
                 chaos_seed: int | None = None) -> dict:
    """Soak the online compaction service with mixed ingest batches.

    Drives ``n_batches`` mixed insert/delete batches through an
    :class:`~repro_torch.online.OnlineCompactionService` alongside a
    no-recompaction twin (same planner, ``auto_redetect=False``) over
    the same edit stream, and checks the service-level guarantees:

    * the write-ahead queue fully drains on both services;
    * re-detection is warm after the soak: a forced re-detect of every
      factorized class launches no NEW bucket shape (every shape was
      seen during the run) and leaves the graph digest unchanged;
    * recompaction pays, monotonically: every re-detection pass leaves
      the realized edge count no higher than it found it, the service's
      triple count never exceeds the no-recompaction baseline, and the
      final advantage strictly beats the initial one;
    * incremental == batch: the final snapshot is digest-identical to a
      from-scratch ``Compactor`` run on the net graph.

    ``backend="device"`` runs every sweep on ``device`` (default
    ``"cuda"``: the hand kernels).  Returns the ``drift`` matrix
    recorded per batch (recompaction latency, queue depth, dirty-class
    count, edge counts) plus the metrics-channel summaries.

    **Durable mode** (``durable_root``): the service journals every
    batch to an on-disk WAL and checkpoints under ``durable_root``.  If
    the root already holds a valid checkpoint (this process is a
    RESTART after a crash) the soak does not re-run the workload: it
    recovers, drains whatever the journal preserved, and gates the
    recovered state -- queue fully drained, digest identical to a
    from-scratch ``Compactor`` over the recovered net graph, recovery
    metrics recorded.  ``chaos_seed`` arms a seeded kill-mode
    :class:`~repro_torch.dist.fault.FaultPlan` (SIGKILL at a random
    injection site) on FRESH durable runs only: run once expecting
    death by SIGKILL, then rerun the same command to prove recovery.
    """
    from ..api import Compactor
    from ..core import sweep as core_sweep
    from ..data.synthetic import SensorGraphSpec, generate
    from ..dist.fault import FaultPlan
    from ..online import OnlineCompactionService
    from ..online.recovery import has_state

    backend = _graph_backend(backend, device)
    svc_kw = dict(detector="gfsp", backend=backend,
                  raw_residue_threshold=6, support_drift_threshold=4,
                  max_backoff=1)

    if durable_root is not None and has_state(durable_root):
        # RESTART path: the journal + checkpoint are the workload now
        svc = OnlineCompactionService.durable(durable_root, **svc_kw)
        reps = svc.drain()
        rec = svc.last_recovery.as_dict() if svc.last_recovery else {}
        net = svc.snapshot.fgraph.expand()
        comp = Compactor(detector="gfsp", backend=backend)
        comp.run(net)
        result = {
            "recovered": True,
            "drained": svc.queue.depth == 0,
            "batches_drained_after_recovery": len(reps),
            "batch_parity_digest": comp.snapshot.digest()
            == svc.snapshot.digest(),
            "recovery": rec,
            "metrics": svc.metrics_summary(),
        }
        svc.close()
        if assert_gates:
            assert result["drained"], "recovered queue not drained"
            assert result["batch_parity_digest"], \
                "recovered state != from-scratch compaction of its net graph"
            assert rec.get("checkpoint_bytes", 0) > 0, rec
        print(f"online soak (recovery): checkpoint step "
              f"{rec.get('checkpoint_step')} "
              f"({rec.get('checkpoint_bytes', 0)} bytes), "
              f"{rec.get('mints_replayed', 0)} mints + "
              f"{rec.get('batches_pending', 0)} batches replayed in "
              f"{rec.get('replay_ms', 0.0):.1f} ms, "
              f"{len(reps)} drained post-recovery, gates "
              f"{'PASS' if assert_gates else 'recorded'}")
        return result

    store = generate(SensorGraphSpec(n_observations=n_observations,
                                     seed=seed))
    # max_backoff=1: the drift cohort's re-plan is rejected until enough
    # singletons accumulate, and a deep rejection backoff would push the
    # eventually-accepted pass past this soak's short horizon
    if durable_root is not None:
        plan = (None if chaos_seed is None
                else FaultPlan.seeded(chaos_seed, mode="kill"))
        svc = OnlineCompactionService.durable(
            durable_root, store, checkpoint_every=3,
            checkpoint_async=False, fault_plan=plan, **svc_kw)
    else:
        svc = OnlineCompactionService(store, **svc_kw)
    base = OnlineCompactionService(store, detector="gfsp", backend=backend,
                                   auto_redetect=False)
    rng = np.random.default_rng(seed)
    term = store.dict.term
    type_term = term(store.TYPE)
    classes = list(svc.snapshot.fgraph.tables.items())
    # complete entity templates per class (every class property, §4.3
    # assumption (a)) sampled from the ORIGINAL store, so inserted
    # entities are candidates for whatever SP a re-detection picks
    full_props = {cid: np.asarray(store.class_properties(cid))
                  for cid, _ in classes}
    full_mats = {cid: store.object_matrix(cid, full_props[cid])[1]
                 for cid, _ in classes}
    inserted: list[str] = []

    def build_batch(b: int):
        """One mixed batch: complete entities cloning existing rows
        (absorb into existing molecules), a drift cohort of SINGLETON
        tuples (shared objects on every property except one current-SP
        column, a unique object there), and -- every third batch --
        deletes of earlier inserts (support decay + payoff-sweep
        pressure).  Without re-detection each singleton mints a
        sub-payoff molecule (Fig. 7 overhead, +1 edge apiece), while
        re-detection shifts the class SP off the churning column and
        absorbs the whole cohort into one high-support molecule."""
        cid, t = classes[b % len(classes)]
        cterm = term(cid)
        fprops = full_props[cid]
        mat = full_mats[cid]
        pterms = [term(int(p)) for p in fprops]
        uniq_col = int(np.searchsorted(fprops, t.props[-1]))
        ins = []
        for j in range(3):          # reuse: clone a full original row
            row = mat[int(rng.integers(0, mat.shape[0]))]
            s = f"e:online/{b}/reuse{j}"
            ins.append((s, type_term, cterm))
            ins += [(s, p, term(int(o))) for p, o in zip(pterms, row)]
            inserted.append(s)
        for j in range(4):          # drift: singleton tuples pile up
            s = f"e:online/{b}/drift{j}"
            ins.append((s, type_term, cterm))
            ins += [(s, p, f"o:uniq/{b}/{j}" if k == uniq_col
                     else f"o:drift/{cterm}/{k}")
                    for k, p in enumerate(pterms)]
            inserted.append(s)
        dels = []
        if b % 3 == 2 and len(inserted) > 6:
            dels = [inserted.pop(int(rng.integers(0, len(inserted))))
                    for _ in range(4)]
        return ins, dels

    drift_rows = []
    for b in range(n_batches):
        ins, dels = build_batch(b)
        for s in (svc, base):
            s.submit(inserts=ins)
            if dels:
                s.submit(delete_entities=dels)
        reps = svc.drain()
        base.drain()
        red = next((r.redetect for r in reps if r.redetect is not None),
                   None)
        drift_rows.append({
            "batch": b,
            "latency_ms": sum(r.latency_ms for r in reps),
            "queue_depth": svc.queue.depth,
            "n_dirty": len(red.considered) if red else 0,
            "redetect_ms": red.exec_time_ms if red else 0.0,
            "redetect_descents": red.descents if red else 0,
            "redetect_rejected": bool(red.rejected) if red else False,
            "redetect_edges_before": red.edges_before if red else 0,
            "redetect_edges_after": red.edges_after if red else 0,
            "edges": svc.snapshot.n_triples,
            "edges_baseline": base.snapshot.n_triples,
        })

    # warm gate: every sweep shape the service will ever need was
    # launched during the soak, so a forced full re-detect must add no
    # new shape -- and must not change the graph it re-derives
    digest_before = svc.snapshot.digest()
    core_sweep.reset_trace_stats()
    svc.redetect(sorted(svc.snapshot.fgraph.tables))
    warm_retraces = core_sweep.trace_count()
    digest_after = svc.snapshot.digest()

    net = svc.snapshot.fgraph.expand()
    comp = Compactor(detector="gfsp", backend=backend)
    comp.run(net)
    gaps = [r["edges"] - r["edges_baseline"] for r in drift_rows]
    result = {
        "n_batches": n_batches,
        "drained": svc.queue.depth == 0 and base.queue.depth == 0,
        "warm_redetect_traces": int(warm_retraces),
        "redetect_digest_stable": digest_after == digest_before,
        "never_above_baseline": all(g <= 0 for g in gaps),
        "redetect_monotone": all(
            r["redetect_edges_after"] <= r["redetect_edges_before"]
            for r in drift_rows if r["n_dirty"]),
        "final_gap": gaps[-1], "first_gap": gaps[0],
        "n_redetects": sum(1 for r in drift_rows if r["n_dirty"]),
        "swap_count": svc.swap_count,
        "batch_parity_digest": comp.snapshot.digest()
        == svc.snapshot.digest(),
        "rows": drift_rows,
        "metrics": svc.metrics_summary(),
    }
    if durable_root is not None:
        result["durable"] = True
        result["wal_segments"] = svc.wal.n_segments
        svc.checkpoint(wait=True)
        svc.close()
    if assert_gates:
        assert result["drained"], "ingest queue not drained"
        assert result["warm_redetect_traces"] == 0, \
            f"re-detection launched new shapes warm: {warm_retraces}"
        assert result["redetect_digest_stable"], \
            "forced re-detect changed graph semantics"
        assert result["never_above_baseline"], \
            f"service edge count exceeded no-recompaction baseline: {gaps}"
        assert result["redetect_monotone"], \
            "a re-detection pass increased the realized edge count"
        assert result["final_gap"] < result["first_gap"], \
            f"recompaction never beat the no-recompaction twin: {gaps}"
        assert result["batch_parity_digest"], \
            "incremental != from-scratch compaction of the net graph"
    print(f"online soak: {n_batches} batches, "
          f"{result['n_redetects']} re-detections, "
          f"{result['swap_count']} swaps, "
          f"edge advantage {gaps[0]} -> {gaps[-1]} vs no-recompaction, "
          f"warm new shapes {warm_retraces}, gates "
          f"{'PASS' if assert_gates else 'recorded'}")
    return result


def frontend_generate(model, toks, frames, max_new: int) -> dict:
    """Greedy generation through ``serve_step`` for an encoder-decoder or
    VLM config: one prefill of ``toks`` (B, T) with the frontend
    embeddings ``frames`` (the VLM's patches go before the text), then
    ``max_new - 1`` decode steps, the device synchronised after each.
    Returns the tokens (B, max_new), each step's (B, V) logits, the last
    cache, the prompt phase's seconds and each decode step's."""
    cfg, dev = model.cfg, model.device
    n = toks.shape[0]
    start = toks.shape[1] + (cfg.frontend_tokens
                             if cfg.frontend == "vision_stub" else 0)
    prefill = make_prefill_step(model, cache_len=start + max_new)
    decode = make_decode_step(model)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    nxt, cache, logits = prefill(toks, frames)
    sync()
    out = {"prefill_s": time.perf_counter() - t0, "decode_s": [],
           "logits": [logits]}
    steps = [nxt]
    for t in range(1, max_new):
        t1 = time.perf_counter()
        pos = torch.full((n, 1), start + t - 1, dtype=torch.int32,
                         device=dev)
        nxt, cache, logits = decode(nxt[:, None], cache, pos)
        sync()
        out["decode_s"].append(time.perf_counter() - t1)
        out["logits"].append(logits)
        steps.append(nxt)
    out["tokens"] = torch.stack(steps, dim=1)
    out["cache"] = cache
    return out


def serve_frontend(model, args, rng) -> dict:
    """An encoder-decoder or VLM config through ``serve_step``: seeded
    frontend embeddings (whisper's frames, the VLM's patches), one
    prefill of every request, greedy decode steps."""
    cfg, dev = model.cfg, model.device
    n, length = args.requests, args.prompt_len
    frames = torch.from_numpy(rng.standard_normal(
        (n, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model)).astype(
        np.float32)).to(dev)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (n, length), dtype=np.int64)).to(dev)
    out = frontend_generate(model, toks, frames, args.max_new)
    print(f"serve_step: {n} requests x {length} tokens + "
          f"{cfg.frontend_tokens} {cfg.frontend} embeddings -> "
          f"{args.max_new} new each in "
          f"{out['prefill_s'] + sum(out['decode_s']):.2f}s")
    return {"outputs": dict(enumerate(out["tokens"].tolist())),
            "plan_savings_pct": 0.0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help=REDUCED_HELP + " (unlike the JAX launcher, "
                         "off by default: the published config)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--shared-frac", type=float, default=0.75,
                    help="fraction of the prompt shared across requests")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="both",
                    choices=("both",) + PREFIX_POLICIES.names(),
                    help="prefix-compaction policy; 'both' runs every "
                         "registered policy and compares their tokens")
    ap.add_argument("--device", default="cuda",
                    help="where the LM and the graph modes' device "
                         "backend run")
    ap.add_argument("--graph-queries", type=int, default=0,
                    help="serve N star BGP queries over a compacted RDF "
                         "graph instead of the LM path")
    ap.add_argument("--bgp", type=int, default=0,
                    help="serve N multi-star BGP queries (joins + "
                         "filters) through the cost-based planner")
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="serve star queries over an N-shard partitioned "
                         "graph (fan-out path) and assert parity with "
                         "the replicated endpoint")
    ap.add_argument("--graph-backend", default="device",
                    choices=("host", "device"),
                    help="compaction sweep and molecule-match backend of "
                         "the graph modes; device runs on --device")
    ap.add_argument("--online", action="store_true",
                    help="soak the online compaction service (mixed "
                         "ingest batches + drift-tracked re-detection) "
                         "and gate the service-level guarantees")
    ap.add_argument("--online-batches", type=int, default=20,
                    help="ingest batches for --online")
    ap.add_argument("--durable", default=None, metavar="DIR",
                    help="durable root for --online: WAL + checkpoints "
                         "under DIR; with existing state, recover and "
                         "gate instead of re-running the workload")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="arm a seeded kill-mode fault plan (SIGKILL at "
                         "a random injection site) on a fresh --durable "
                         "run; restart the same command to recover")
    args = ap.parse_args(argv)

    if args.online:
        return serve_online(args.online_batches, seed=args.seed,
                            backend=args.graph_backend,
                            device=args.device, durable_root=args.durable,
                            chaos_seed=args.chaos)
    if args.sharded:
        return serve_sharded_queries(
            max(args.graph_queries, 24), n_shards=args.sharded,
            seed=args.seed, backend=args.graph_backend, device=args.device)
    if args.bgp:
        return serve_bgp_queries(args.bgp, seed=args.seed,
                                 backend=args.graph_backend,
                                 device=args.device)
    if args.graph_queries:
        return serve_graph_queries(args.graph_queries, seed=args.seed,
                                   backend=args.graph_backend,
                                   device=args.device)

    dev = resolve_device(args.device)
    cfg = arch_config(args.arch, reduced_cfg=args.reduced, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = LM(cfg, device=dev, generator=gen)
    print(f"lm {cfg.name}{' (reduced)' if args.reduced else ''}: "
          f"{cfg.family}, {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.dtype}, on {dev}")
    rng = np.random.default_rng(args.seed)
    if cfg.encoder_layers or cfg.frontend != "none":
        return serve_frontend(model, args, rng)

    shared_len = int(args.prompt_len * args.shared_frac)
    system_prompt = rng.integers(1, cfg.vocab_size, (shared_len,),
                                 dtype=np.int32)
    prompts = [np.concatenate([
        system_prompt,
        rng.integers(1, cfg.vocab_size, (args.prompt_len - shared_len,),
                     dtype=np.int32)]) for _ in range(args.requests)]

    policies = (PREFIX_POLICIES.names() if args.policy == "both"
                else (args.policy,))
    results = {}
    shared_plan = None
    for policy in policies:
        eng = Engine(model, cache_len=args.prompt_len + args.max_new,
                     chunk=32, policy=policy, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new=args.max_new))
        t0 = time.perf_counter()
        outs = eng.run()
        dt = time.perf_counter() - t0
        results[policy] = outs
        plan = eng.last_plan
        extra = ""
        if eng.policy.plan and plan is not None:
            shared_plan = shared_plan or plan
            verb = "kv_savings" if eng.policy.share else "would_save"
            extra = (f" molecules={plan.molecule_tokens.shape[0]} "
                     f"depth={plan.depth_chunks * plan.chunk} "
                     f"{verb}={plan.savings_pct:.1f}%")
        print(f"{policy:10s}: {len(outs)} requests x {args.max_new} tokens "
              f"in {dt:.2f}s{extra}")
    first = results[policies[0]]
    if cfg.dtype == "float32":
        assert all(r == first for r in results.values()), \
            "every prefix policy must produce identical tokens"
        if len(policies) > 1:
            print("all policies produce identical outputs: information "
                  "preserved (Def. 4.10)")
    else:
        toks = [np.asarray([r[i] for i in sorted(r)]) for r in
                results.values()]
        agree = min(float((t == toks[0]).mean()) for t in toks)
        print(f"tokens agreeing across policies ({cfg.dtype}): {agree:.3f}")
    return {"outputs": first,
            "plan_savings_pct": shared_plan.savings_pct
            if shared_plan else 0.0}


if __name__ == "__main__":
    main()
