"""The port's BGP engine against the JAX package's on the same stores and
queries: the algebra and its validation, molecule-level joins, repeated
variables, filter pushdown and every filter op, the planner's choices,
join order, mixed-slot re-pricing and cost estimates, the
``am``/``ami``/``molecule_of`` accessors, random multi-star BGPs over
random graphs (hypothesis), the cost-model fit, the calibration report,
the device path (on the CPU) and the reference's BGP matrix digests.

Bindings, ``canonical()`` bytes, plans and ``max_intermediate`` are
compared exactly; cost estimates and fitted constants to 1e-12
relative.  The reference is imported inside the ``R`` fixture (it pulls
in jax), so on a machine without jax every comparison skips.
"""
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.api import Compactor
from repro_torch.convert import store_from_arrays
from repro_torch.core import sweep
from repro_torch.core.triples import TripleStore
from repro_torch.data.synthetic import (MEASUREMENT, OBSERVATION, P_MODEL,
                                        P_PROCEDURE, P_RESULT, P_TIME,
                                        P_VALUE, SENSOR, SensorGraphSpec,
                                        generate)
from repro_torch.query import (QUERY_EXEC, BGPBindings, BGPQuery, Filter,
                               QueryEngine, StarPattern, eval_bgp_reference,
                               plan_bgp)
from repro_torch.query.bgp import (CostModel, calibrate, calibration_report,
                                   execute_bgp, fit_cost_model, is_var)
from repro_torch.query.bgp.planner import COST, plan_star

ROOT = Path(__file__).resolve().parents[1]
OPS = ("==", "!=", "<", "<=", ">", ">=")
STRATEGIES = ("auto", "raw", "factorized")
REL = 1e-12


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    import repro.query as query
    import repro.query.bgp as bgp
    import repro.query.bgp.calibrate as cal
    import repro.query.bgp.planner as planner
    from repro.api import Compactor as JCompactor
    from repro.core import sweep as jsweep
    from repro.core.triples import TripleStore as JTripleStore
    from repro.data import synthetic as syn
    from repro.query import batch
    return types.SimpleNamespace(query=query, bgp=bgp, cal=cal,
                                 planner=planner, Compactor=JCompactor,
                                 sweep=jsweep, TripleStore=JTripleStore,
                                 syn=syn, batch=batch)


@pytest.fixture(scope="module")
def W(R):
    """The sensor graph with sensor stars, compacted by both packages."""
    ref = R.syn.generate(R.syn.SensorGraphSpec(
        n_observations=400, seed=3, include_sensor_metadata=True))
    store = store_from_arrays(list(ref.dict._terms), ref.spo)
    jc = R.Compactor()
    jc.run(ref)
    tc = Compactor("gfsp", "host")
    tc.run(store)
    assert tc.snapshot.digest() == jc.snapshot.digest()
    jeng, teng = R.query.QueryEngine(jc.fgraph), QueryEngine(tc.fgraph)
    return types.SimpleNamespace(jeng=jeng, teng=teng, jfg=jc.fgraph,
                                 tfg=tc.fgraph, exp=tc.fgraph.expand(),
                                 d=store.dict)


def ids(W, *terms):
    return tuple(W.d.lookup(t) for t in terms)


def pair(R, stars, filters=()):
    """The same id-level BGP in both packages: ``stars`` are (subject,
    arms, class id), ``filters`` (var, op, value id)."""
    def build(ns):
        return ns.BGPQuery(
            stars=tuple(ns.StarPattern(s, tuple(a), class_id=c)
                        for s, a, c in stars),
            filters=tuple(ns.Filter(*f) for f in filters))
    return build(R.bgp), build(types.SimpleNamespace(
        BGPQuery=BGPQuery, StarPattern=StarPattern, Filter=Filter))


def same_plan(jp, tp):
    assert tp.order == jp.order
    assert tp.strategies == jp.strategies
    for a, b in zip(jp.stars, tp.stars):
        assert (b.index, b.strategy, b.deferred) == \
            (a.index, a.strategy, a.deferred)
        for f in ("est_rows", "est_frontier", "cost"):
            assert getattr(b, f) == pytest.approx(getattr(a, f), rel=REL), f


def same_answer(jout, tout):
    """Bindings (rows in order), canonical bytes and stats equal."""
    jb, js = jout
    tb, ts = tout
    assert tb.columns == jb.columns
    assert tb.rows.tobytes() == jb.rows.tobytes()
    assert tb.canonical().tobytes() == jb.canonical().tobytes()
    same_plan(js["plan"], ts["plan"])
    assert {k: v for k, v in ts.items() if k != "plan"} == \
        {k: v for k, v in js.items() if k != "plan"}


def both(W, R, stars, filters=(), **kw):
    """Answer one query in both packages; returns the port's answer,
    after holding it against the reference's and the port's oracle."""
    jq, tq = pair(R, stars, filters)
    jout = W.jeng.query_bgp(jq, return_stats=True, **kw)
    tout = W.teng.query_bgp(tq, return_stats=True, **kw)
    same_answer(jout, tout)
    assert tout[0].same_as(eval_bgp_reference(W.exp, tq))
    return tout


# ---------------------------------------------------------------------------
# algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make,match", [
    (lambda: StarPattern("obs/0", ((1, 2),)), "subject"),
    (lambda: Filter("?v", "~", 3), "op"),
    (lambda: Filter("v", "==", 3), "var"),
    (lambda: BGPQuery(stars=()), "at least one star"),
    (lambda: BGPQuery(stars=(StarPattern("?s", ((1, "?v"),)),),
                      filters=(Filter("?w", "==", 0),)), "unbound"),
], ids=["star-subject", "filter-op", "filter-var", "no-star", "unbound"])
def test_validation(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_variables_and_normalization(R):
    jq, tq = pair(R, [("?s", ((np.int64(1), "?v"),), None),
                      ("?v", ((2, "?w"), (3, np.int32(7))), 5)])
    assert tq.variables == jq.variables == ("?s", "?v", "?w")
    assert tq.stars[1].ground_arms == jq.stars[1].ground_arms == [(3, 7)]
    assert tq.stars[1].var_arms == jq.stars[1].var_arms == [(2, "?w")]
    assert tq.filters_on("?v") == [] and is_var("?x") and not is_var(3)


@pytest.mark.parametrize("op", OPS)
def test_filter_apply_matches_reference(R, op):
    col = np.array([1, 5, 5, 9, -2, 2**40])
    for v in (5, 0, 2**40):
        assert Filter("?v", op, v).apply(col).tolist() == \
            R.bgp.Filter("?v", op, v).apply(col).tolist()


@pytest.mark.parametrize("shape", [(0, 2), (1, 3), (50, 2)])
def test_canonical_bytes_match_reference(R, shape):
    rng = np.random.default_rng(shape[0])
    rows = rng.integers(0, 4, shape)
    rows = np.concatenate([rows, rows[: shape[0] // 2]])
    cols = tuple(f"?c{i}" for i in range(shape[1]))
    a, b = BGPBindings(cols, rows), R.bgp.BGPBindings(cols, rows)
    assert a.canonical().dtype == b.canonical().dtype == np.int64
    assert a.canonical().tobytes() == b.canonical().tobytes()
    assert a.same_as(BGPBindings(cols, rows[::-1]))


# ---------------------------------------------------------------------------
# joins and filters: the port equals the reference
# ---------------------------------------------------------------------------

def _two_star(W, model="model/1"):
    obs, sen, p_proc, p_model, m = ids(W, OBSERVATION, SENSOR, P_PROCEDURE,
                                       P_MODEL, model)
    return [("?o", ((p_proc, "?s"),), obs), ("?s", ((p_model, m),), sen)]


def _chain(W, model="model/0"):
    obs, sen, meas, p_proc, p_res, p_model, p_val, m = ids(
        W, OBSERVATION, SENSOR, MEASUREMENT, P_PROCEDURE, P_RESULT, P_MODEL,
        P_VALUE, model)
    return [("?o", ((p_proc, "?s"), (p_res, "?m")), obs),
            ("?s", ((p_model, m),), sen), ("?m", ((p_val, "?v"),), meas)]


def test_two_star_join_is_molecule_to_molecule(W, R):
    b_f, st_f = both(W, R, _two_star(W), strategy="factorized")
    b_r, st_r = both(W, R, _two_star(W), strategy="raw")
    assert b_f.n_rows > 0 and b_f.same_as(b_r)
    assert st_f["deferred_stars"] == 2
    assert st_f["max_intermediate"] < st_r["max_intermediate"]
    obs, sen = ids(W, OBSERVATION, SENSOR)
    assert st_f["max_intermediate"] <= W.tfg.ami(obs) + W.tfg.ami(sen)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("model", ["model/0", "model/2"])
def test_three_star_chain(W, R, strategy, model):
    b, _ = both(W, R, _chain(W, model), strategy=strategy)
    assert b.n_rows > 0


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_repeated_var_within_star(W, R, strategy):
    obs, p_proc, p_gen = ids(W, OBSERVATION, P_PROCEDURE, "ssn:generatedBy")
    b, _ = both(W, R, [("?o", ((p_proc, "?s"), (p_gen, "?s")), obs)],
                strategy=strategy)
    assert b.n_rows > 0


def test_filter_pushdown_shrinks_molecule_frontier(W, R):
    meas, p_val, v2 = ids(W, MEASUREMENT, P_VALUE, "val/2")
    star = [("?m", ((p_val, "?v"),), meas)]
    flt = [("?v", "<", v2)]
    pushed, st_p = both(W, R, star, flt, strategy="factorized")
    posthoc, st_h = both(W, R, star, flt, strategy="factorized",
                         posthoc_filters=True)
    assert pushed.n_rows > 0 and pushed.same_as(posthoc)
    assert st_p["filters_pushed"] > 0 and st_h["filters_pushed"] == 0
    assert st_p["max_intermediate"] < st_h["max_intermediate"]


@pytest.mark.parametrize("op", OPS)
def test_filter_ops(W, R, op):
    meas, p_val, v = ids(W, MEASUREMENT, P_VALUE, "val/1")
    for strategy in STRATEGIES:
        for posthoc in (False, True):
            both(W, R, [("?m", ((p_val, "?v"),), meas)], [("?v", op, v)],
                 strategy=strategy, posthoc_filters=posthoc)


def test_filtered_chain_and_disconnected_stars(W, R):
    """A filter on a chain's far end, and two stars sharing no variable
    (the cross product the join order leaves to the end)."""
    obs, meas, p_time, p_val, t3, v6 = ids(
        W, OBSERVATION, MEASUREMENT, P_TIME, P_VALUE, "time/3", "val/6")
    for op in ("<", ">="):
        for strategy in STRATEGIES:
            both(W, R, _chain(W, "model/1"), [("?v", op, v6)],
                 strategy=strategy)
    for strategy in STRATEGIES:
        both(W, R, [("?o", ((p_time, t3),), obs),
                    ("?m", ((p_val, v6),), meas)], strategy=strategy)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def _planner_queries(W):
    obs, meas, p_res, p_val = ids(W, OBSERVATION, MEASUREMENT, P_RESULT,
                                  P_VALUE)
    t = W.tfg.tables[meas]
    insp = [("?m", tuple((int(p), int(o)) for p, o in
                         zip(t.props, t.objects[0])), meas)]
    return {"insp_ground": insp,
            "offsp_var": [("?o", ((p_res, "?m"),), obs)],
            "var_arm": [("?m", ((p_val, "?v"),), meas)],
            "two_star": _two_star(W), "chain": _chain(W, "model/1")}


@pytest.mark.parametrize("name", ["insp_ground", "offsp_var", "var_arm",
                                  "two_star", "chain"])
def test_plans_match_reference(W, R, name):
    stars = _planner_queries(W)[name]
    jq, tq = pair(R, stars)
    for strategy in STRATEGIES:
        same_plan(R.bgp.plan_bgp(W.jfg, jq, strategy=strategy),
                  plan_bgp(W.tfg, tq, strategy=strategy))
    plan = plan_bgp(W.tfg, tq)
    if name == "insp_ground":       # one molecule-row probe wins
        assert plan.strategies == ("factorized",) and plan.stars[0].deferred
    if name == "offsp_var":         # residual property: raw wins
        assert plan.strategies == ("raw",)
    if name == "two_star":          # the ground sensor star leads
        assert plan.order[0] == 1
        assert plan.stars[1].est_frontier <= plan.stars[0].est_frontier


def test_strategy_override(W, R):
    stars = _planner_queries(W)["var_arm"]
    _, tq = pair(R, stars)
    assert set(plan_bgp(W.tfg, tq, strategy="raw").strategies) == {"raw"}
    assert set(plan_bgp(W.tfg, tq, strategy="factorized").strategies) == \
        {"factorized"}
    with pytest.raises(ValueError, match="strategy"):
        plan_bgp(W.tfg, tq, strategy="molecular")


@pytest.mark.parametrize("c_mix", [0.0, 1e9, None])
def test_mixed_slot_repricing(W, R, c_mix):
    """The second pass prices the granularity crossing: at an unbounded
    price no deferred star keeps a non-deferred partner; every variant
    answers the same."""
    jq, tq = pair(R, _chain(W, "model/1"))
    tcm = CostModel() if c_mix is None else CostModel(c_mix=c_mix)
    jcm = R.bgp.CostModel() if c_mix is None else R.bgp.CostModel(c_mix=c_mix)
    jp = R.bgp.plan_bgp(W.jfg, jq, cost_model=jcm)
    tp = plan_bgp(W.tfg, tq, cost_model=tcm)
    same_plan(jp, tp)
    if c_mix == 1e9:
        var_sets = [set(s.variables) for s in tq.stars]
        for i, sp in enumerate(tp.stars):
            if sp.deferred:
                assert not any(var_sets[i] & var_sets[j]
                               for j, o in enumerate(tp.stars)
                               if j != i and not o.deferred)
    got, _ = execute_bgp(W.tfg, tq, tp, raw_store=W.teng.raw_store)
    want, _ = R.bgp.execute_bgp(W.jfg, jq, jp, raw_store=W.jeng.raw_store)
    assert got.rows.tobytes() == want.rows.tobytes()
    assert got.same_as(eval_bgp_reference(W.exp, tq))


@pytest.mark.parametrize("mixed", [0, 2])
def test_mixed_partner_count_raises_deferred_cost(W, R, mixed):
    jq, tq = pair(R, _chain(W))
    for si in range(len(tq.stars)):
        a = R.planner.plan_star(W.jfg, jq, si, mixed_partners=mixed)
        b = plan_star(W.tfg, tq, si, mixed_partners=mixed)
        assert (b.strategy, b.deferred) == (a.strategy, a.deferred)
        assert b.cost == pytest.approx(a.cost, rel=REL)
        if plan_star(W.tfg, tq, si, strategy="factorized").deferred:
            assert b.cost >= plan_star(W.tfg, tq, si).cost


def test_single_star_cost_matches_features(W, R):
    """Planner cost and calibrate features are the same linear form, in
    both packages."""
    obs, p_proc = ids(W, OBSERVATION, P_PROCEDURE)
    jq, tq = pair(R, [("?o", ((p_proc, "?s"),), obs)])
    for strategy, mode in (("raw", "raw"), ("factorized", None)):
        sp = plan_star(W.tfg, tq, 0, strategy=strategy)
        m = mode or ("deferred" if sp.deferred else "factorized")
        feats = calibrate.star_features(W.tfg, tq, 0, m)
        np.testing.assert_allclose(
            feats, R.cal.star_features(W.jfg, jq, 0, m), rtol=REL)
        assert sp.cost == pytest.approx(float(COST.as_array() @ feats),
                                        rel=1e-9)


@pytest.mark.parametrize("strategy", ["raw", "factorized"])
def test_query_features_match_reference(W, R, strategy):
    for stars in _planner_queries(W).values():
        jq, tq = pair(R, stars)
        np.testing.assert_allclose(
            calibrate.query_features(W.tfg, tq, strategy),
            R.cal.query_features(W.jfg, jq, strategy), rtol=REL)


def test_cost_model_defaults_match_reference(R):
    assert CostModel.FEATURES == R.bgp.CostModel.FEATURES
    assert CostModel().as_array().tolist() == \
        R.bgp.CostModel().as_array().tolist()


# ---------------------------------------------------------------------------
# FactorizedGraph accessors
# ---------------------------------------------------------------------------

def test_fgraph_accessors_match_reference(W):
    fg, jfg = W.tfg, W.jfg
    rng = np.random.default_rng(0)
    for cid, t in fg.tables.items():
        assert fg.ami(cid) == jfg.ami(cid) == t.n_molecules
        assert fg.am(cid) == jfg.am(cid) == int(fg.support(cid).sum())
        ents, _ = fg.members_of(int(t.surrogates[0]))
        assert (fg.molecule_of(cid, ents) == t.surrogates[0]).all()
        probe = np.concatenate([
            rng.integers(0, len(W.d) + 10, 200), ents,
            fg.members_of(t.surrogates)[0][:50], [10**6]])
        got = fg.molecule_of(cid, probe)
        assert got.tobytes() == jfg.molecule_of(cid, probe).tobytes()
        assert got[-1] == -1
    assert fg.am(-5) == fg.ami(-5) == 0
    assert (fg.molecule_of(-5, np.arange(4)) == -1).all()
    assert fg.molecule_of(next(iter(fg.tables)), []).shape == (0,)


# ---------------------------------------------------------------------------
# hypothesis: random multi-star BGPs x random graphs x random deletes
# ---------------------------------------------------------------------------

def _random_triples(rng, n_ent, n_props, n_obj, n_cls):
    triples = []
    for i in range(n_ent):
        e = f"e{i}"
        for c in range(n_cls):
            if c == 0 or rng.random() < 0.4:
                triples.append((e, "rdf:type", f"C{c}"))
        for p in range(n_props):
            if rng.random() < 0.85:
                triples.append((e, f"p{p}", f"o{rng.integers(0, n_obj)}"))
    return triples


def _random_bgp(rng, d, n_props, n_obj, n_cls):
    """1-3 stars chained by shared variables, random ground/var objects,
    class constraints and filters -- as (stars, filters) tuples."""
    n_stars = int(rng.integers(1, 4))
    stars = []
    for i in range(n_stars):
        arms = []
        n_arms = int(rng.integers(1, min(n_props, 3) + 1))
        for k, p in enumerate(rng.choice(n_props, size=n_arms,
                                         replace=False)):
            pid = d.lookup(f"p{p}")
            if pid is None:
                continue
            if rng.random() < 0.35:
                arms.append((pid, f"?v{i}_{k}"))
            else:
                o = d.lookup(f"o{rng.integers(0, n_obj + 1)}")
                if o is not None:
                    arms.append((pid, o))
        if i + 1 < n_stars:
            pid = d.lookup(f"p{rng.integers(0, n_props)}")
            if pid is not None:
                arms.append((pid, f"?s{i + 1}"))
        if not arms:
            return None
        cid = None
        if rng.random() < 0.7:
            cid = d.lookup(f"C{rng.integers(0, n_cls)}")
        stars.append((f"?s{i}", tuple(arms), cid))
    variables = BGPQuery(stars=tuple(
        StarPattern(s, a, class_id=c) for s, a, c in stars)).variables
    filters = []
    for v in variables:
        if rng.random() < 0.3:
            val = d.lookup(f"o{rng.integers(0, n_obj)}")
            if val is not None:
                filters.append((v, OPS[int(rng.integers(0, 6))], val))
    return stars, filters


@settings(max_examples=20, deadline=None)
@given(n_ent=st.integers(2, 14), n_props=st.integers(2, 4),
       n_obj=st.integers(1, 3), n_cls=st.integers(1, 2),
       seed=st.integers(0, 10_000), with_deletes=st.booleans())
def test_bgp_strategy_parity_property(R, n_ent, n_props, n_obj, n_cls, seed,
                                      with_deletes):
    """Every random multi-star BGP -- planner-chosen, fixed raw and fixed
    factorized, filters pushed and post-hoc -- answers as the reference
    does (rows, stats, plan) and as the oracle on expand(), including
    post-delete states, incomplete molecules and multi-typed entities."""
    rng = np.random.default_rng(seed)
    triples = _random_triples(rng, n_ent, n_props, n_obj, n_cls)
    ref = R.TripleStore.from_triples(triples)
    store = TripleStore.from_triples(triples)
    assert store.spo.tobytes() == ref.spo.tobytes()
    jc = R.Compactor(min_predicted_savings=-10**9)
    # incomplete molecules and multi-typed entities: the JAX package's
    # scoring is the port's complete objective
    tc = Compactor(min_predicted_savings=-10**9,
                   detector_opts={"objective": "complete"})
    jc.run(ref)
    tc.run(store)
    if with_deletes and store.n_triples:
        k = int(rng.integers(1, min(4, store.n_triples) + 1))
        rows = store.spo[rng.choice(store.n_triples, size=k, replace=False)]
        jc.delete(triples=rows)
        tc.delete(triples=rows)
    assert tc.snapshot.digest() == jc.snapshot.digest()
    W = types.SimpleNamespace(jeng=R.query.QueryEngine(jc.fgraph),
                              teng=QueryEngine(tc.fgraph),
                              exp=tc.fgraph.expand())
    for _ in range(4):
        q = _random_bgp(rng, store.dict, n_props, n_obj, n_cls)
        if q is None:
            continue
        for strategy in STRATEGIES:
            for posthoc in (False, True):
                both(W, R, *q, strategy=strategy, posthoc_filters=posthoc)


# ---------------------------------------------------------------------------
# the cost-model fit and the calibration report
# ---------------------------------------------------------------------------

@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 999))
def test_fit_cost_model_recovers_planted_constants(R, seed):
    rng = np.random.default_rng(seed)
    c_true = rng.uniform(0.5, 8.0, size=6)
    A = rng.uniform(0.0, 1000.0, size=(40, 6))
    samples = [(A[i], float(A[i] @ c_true)) for i in range(len(A))]
    got = fit_cost_model(samples, prior=CostModel(), l2=1e-9).as_array()
    want = R.bgp.fit_cost_model(samples, prior=R.bgp.CostModel(),
                                l2=1e-9).as_array()
    np.testing.assert_allclose(got, want, rtol=REL)
    np.testing.assert_allclose(got, c_true / c_true[0], rtol=1e-3)


def test_fit_cost_model_pins_unidentified_features_to_prior(R):
    rng = np.random.default_rng(0)
    c_true = np.array([2.0, 4.0, 1.0, 0.5, 3.0, 6.0])
    A = rng.uniform(0.0, 1000.0, size=(40, 6))
    A[:, 5] = 0.0                       # mix never exercised
    samples = [(A[i], float(A[i] @ c_true)) for i in range(len(A))]
    got = fit_cost_model(samples, prior=CostModel(), l2=1e-6)
    want = R.bgp.fit_cost_model(samples, prior=R.bgp.CostModel(), l2=1e-6)
    np.testing.assert_allclose(got.as_array(), want.as_array(), rtol=REL)
    np.testing.assert_allclose(got.as_array()[:5], c_true[:5] / c_true[0],
                               rtol=1e-3)
    assert got.c_mix > 0
    # the default arguments (prior = the committed constants, l2 = 0.5)
    np.testing.assert_allclose(fit_cost_model(samples).as_array(),
                               R.bgp.fit_cost_model(samples).as_array(),
                               rtol=REL)


def test_calibration_report(W, R):
    """The report's shape, and its fit: the port's timed samples fitted
    by both packages give the same constants."""
    obs, p_proc, p_time, t3 = ids(W, OBSERVATION, P_PROCEDURE, P_TIME,
                                  "time/3")
    _, tq = pair(R, [("?o", ((p_proc, "?s"), (p_time, t3)), obs)])
    w = {"probe": [tq], "chain": [pair(R, _chain(W))[1]]}
    rep = calibration_report(W.teng, w)
    assert rep["n_samples"] == 4         # raw + factorized per workload
    assert set(rep["fitted"]) == set(rep["committed"]) == \
        {"mol", "residual", "emit", "scan", "pair", "mix"}
    assert rep["committed"] == {k: round(float(v), 4) for k, v in zip(
        CostModel.FEATURES, R.bgp.CostModel().as_array())}
    assert rep["rel_l1_error"] >= 0.0
    samples = calibrate.collect_samples(W.teng, w)
    np.testing.assert_allclose(fit_cost_model(samples).as_array(),
                               R.bgp.fit_cost_model(samples).as_array(),
                               rtol=REL)


# ---------------------------------------------------------------------------
# the device path, on the CPU
# ---------------------------------------------------------------------------

def test_device_path_zero_warm_first_launches(W, R):
    """``backend="device"`` with ``device="cpu"``: the same answers and
    stats as the reference's device path, the same bucket shapes, one
    counted batch per call, and no new shape on a warm rerun."""
    jq, tq = pair(R, _chain(W, "model/1"))
    eng = QueryEngine(W.tfg, device="cpu")
    sweep.clear_compile_cache()
    R.sweep.reset_trace_stats()
    b0 = QUERY_EXEC["batches"]
    jb0 = R.batch.QUERY_EXEC["batches"]
    for strategy in ("factorized", "auto"):
        same_answer(W.jeng.query_bgp(jq, strategy=strategy, backend="device",
                                     return_stats=True),
                    eng.query_bgp(tq, strategy=strategy, backend="device",
                                  return_stats=True))
    cold = dict(sweep.TRACE_COUNTS)
    assert cold and set(cold) == set(R.sweep.TRACE_COUNTS)
    assert QUERY_EXEC["batches"] - b0 == 2 == \
        R.batch.QUERY_EXEC["batches"] - jb0
    again = eng.query_bgp(tq, strategy="factorized", backend="device")
    assert dict(sweep.TRACE_COUNTS) == cold       # no new shape warm
    assert again.same_as(eval_bgp_reference(W.exp, tq))


def test_bgp_cache_follows_the_snapshot(W):
    eng = QueryEngine(W.tfg, device="cpu", epoch=3)
    tq = BGPQuery(stars=(StarPattern(
        "?m", ((ids(W, P_VALUE)[0], "?v"),),
        class_id=ids(W, MEASUREMENT)[0]),))
    eng.query_bgp(tq)
    cache = eng._bgp_cache
    assert cache
    eng.rebind(W.tfg, 3)                  # the same snapshot: kept
    assert eng._bgp_cache is cache
    eng.rebind(W.tfg, 4)                  # a swap: dropped
    assert eng._bgp_cache == {}


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without CUDA")
def test_device_backend_without_cuda_raises(W):
    eng = QueryEngine(W.tfg)              # device="cuda", the default
    q = BGPQuery(stars=(StarPattern("?o", ((ids(W, P_RESULT)[0], "?m"),),
                                    class_id=ids(W, OBSERVATION)[0]),))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eng.query_bgp(q, strategy="raw", backend="device")
    assert eng.query_bgp(q, strategy="raw").n_rows > 0    # host is fine


# ---------------------------------------------------------------------------
# the reference's BGP matrix (BENCH_fsp.json), on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def matrix():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    bench = json.loads((ROOT / "BENCH_fsp.json").read_text())["bgp"]
    store = generate(SensorGraphSpec(
        n_observations=chip_smoke.BGP_MATRIX_OBSERVATIONS,
        seed=chip_smoke.BGP_MATRIX_SEED, include_sensor_metadata=True))
    assert store.n_triples == bench["graph"]["n_triples"]
    comp = Compactor("gfsp", "device", backend_opts={"device": "cpu"})
    comp.run(store)
    eng = QueryEngine(comp.fgraph, device="cpu")
    return (chip_smoke, bench, eng,
            chip_smoke.bgp_workloads(comp.fgraph, store.dict))


@pytest.mark.parametrize("name", ["lookup", "var_arm", "filter", "2star",
                                  "3star", "mixed"])
def test_bench_matrix_digests(matrix, name):
    """Every cell of each workload gives the binding-set digest, rows and
    largest intermediate ``BENCH_fsp.json`` records for the reference."""
    cs, bench, eng, wl = matrix
    want = {(c["strategy"], c["backend"]): c
            for c in bench["workloads"][name]}
    cells = cs.BGP_CELLS + ((("posthoc", "factorized", "host"),)
                            if name == "filter" else ())
    for label, strategy, backend in cells:
        out = [eng.query_bgp(q, strategy=strategy, backend=backend,
                             posthoc_filters=label == "posthoc",
                             return_stats=True) for q in wl[name]]
        ref = want.get((label, backend), want[(label, "host")])
        assert cs.bgp_digest([b for b, _ in out]) == ref["digest"]
        assert sum(b.n_rows for b, _ in out) == ref["n_rows"]
        assert max(s["max_intermediate"] for _, s in out) == \
            ref["max_intermediate"]
