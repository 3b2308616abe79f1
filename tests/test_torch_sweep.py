"""repro_torch device star counting and bucketed sweeps against the JAX
reference: ami_device / ami_device_batch / multiplicities_device, the
bucket ladder, and DeviceSweepWorkspace.sweep_candidates, exactly."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import star as jstar
from repro.core import sweep as jsweep
from repro.data.synthetic import SensorGraphSpec, generate
from repro_torch.convert import store_from_arrays
from repro_torch.core import star, sweep


def _mat(rng, n, k, distinct):
    return rng.integers(-1, distinct, (n, k)).astype(np.int32)


@pytest.mark.parametrize("n,k,distinct", [(1, 2, 3), (100, 3, 3),
                                          (500, 4, 6), (777, 8, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_ami_device_matches_reference(n, k, distinct, masked):
    rng = np.random.default_rng(n + k)
    mat = _mat(rng, n, k, distinct)
    valid = rng.random(n) < 0.7 if masked else None
    tv = None if valid is None else torch.from_numpy(valid)
    jv = None if valid is None else jnp.asarray(valid)
    got = star.ami_device(torch.from_numpy(mat), valid=tv)
    want = jstar.ami_device(jnp.asarray(mat), valid=jv, use_kernel=False)
    assert int(got) == int(want)
    if valid is not None:
        assert int(got) == jstar.ami(mat[valid])


@pytest.mark.parametrize("valid_shape", ["none", "n", "cn"])
@pytest.mark.parametrize("fused", [False, True])
def test_ami_device_batch_matches_reference(valid_shape, fused):
    rng = np.random.default_rng(11)
    n, k, c = 300, 5, 6
    parent = _mat(rng, n, k, 4)
    masks = rng.integers(0, 2, (c, k)).astype(np.int32)
    stack = parent[None] * masks[:, None, :]
    valid = {"none": None, "n": rng.random(n) < 0.8,
             "cn": rng.random((c, n)) < 0.8}[valid_shape]
    tv = None if valid is None else torch.from_numpy(valid)
    if fused:
        got = star.ami_device_batch(torch.from_numpy(parent), valid=tv,
                                    col_masks=torch.from_numpy(masks))
    else:
        got = star.ami_device_batch(torch.from_numpy(stack), valid=tv)
    want = jstar.ami_device_batch(
        jnp.asarray(stack), valid=None if valid is None else jnp.asarray(valid),
        use_kernel=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("masked", [False, True])
def test_multiplicities_device_matches_reference(masked):
    rng = np.random.default_rng(5)
    mat = _mat(rng, 400, 3, 4)
    valid = rng.random(400) < 0.6 if masked else None
    got = star.multiplicities_device(
        torch.from_numpy(mat),
        valid=None if valid is None else torch.from_numpy(valid))
    want = jstar.multiplicities_device(
        jnp.asarray(mat), valid=None if valid is None else jnp.asarray(valid),
        use_kernel=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if valid is None:
        np.testing.assert_array_equal(got.numpy(), jstar.multiplicities(mat))


@pytest.mark.parametrize("fn", ["bucket_rows", "bucket_cols",
                                "bucket_candidates"])
def test_bucket_ladder_matches_reference(fn):
    for x in list(range(0, 70)) + [127, 128, 129, 255, 256, 257, 1000,
                                   1 << 20, (1 << 20) + 1]:
        assert getattr(sweep, fn)(x) == getattr(jsweep, fn)(x), (fn, x)
    assert sweep.MAX_SWEEP_CANDIDATES == jsweep.MAX_SWEEP_CANDIDATES


@pytest.fixture(scope="module")
def graphs():
    """One sensor graph in both packages (ids carried across)."""
    ref = generate(SensorGraphSpec(n_observations=800, seed=3))
    return ref, store_from_arrays(list(ref.dict._terms), ref.spo)


def _class_args(store, name):
    cid = store.dict.lookup(name)
    stats = store.class_stats(cid)
    return (cid, tuple(int(p) for p in stats.properties),
            int(stats.properties.shape[0]), stats.n_instances)


@pytest.mark.parametrize("cls", ["ssn:Observation", "ssn:Measurement"])
@pytest.mark.parametrize("stack", ["drop_one", "lattice", "random"])
def test_device_sweep_candidates_match_reference(graphs, cls, stack):
    ref, port = graphs
    cid, props, n_s, am = _class_args(ref, cls)
    rng = np.random.default_rng(len(props))
    masks = {"drop_one": 1 - np.eye(n_s, dtype=np.int32),
             "lattice": (np.arange(1, 1 << n_s)[:, None]
                         >> np.arange(n_s)[None, :]) & 1,
             "random": rng.integers(0, 3, (300, n_s))}[stack]
    ws = sweep.DeviceSweepWorkspace(port, cid, props, n_s, am, device="cpu")
    edges, amis = ws.sweep_candidates(masks)
    jws = jsweep.DeviceSweepWorkspace(ref, cid, props, n_s, am,
                                      use_kernel=False)
    jedges, jamis = jws.sweep_candidates(masks)
    hws = jsweep.HostSweepWorkspace(ref, cid, props, n_s, am)
    hedges, hamis = hws.sweep_candidates(masks)
    np.testing.assert_array_equal(amis, np.asarray(jamis))
    np.testing.assert_array_equal(edges, np.asarray(jedges))
    np.testing.assert_array_equal(amis, hamis)
    np.testing.assert_array_equal(edges, hedges)


def test_device_descent_matches_reference(graphs):
    """A whole greedy descent (sweep + descend) on both workspaces."""
    ref, port = graphs
    cid, props, n_s, am = _class_args(ref, "ssn:Observation")
    ws = sweep.DeviceSweepWorkspace(port, cid, props, n_s, am, device="cpu")
    jws = jsweep.DeviceSweepWorkspace(ref, cid, props, n_s, am,
                                      use_kernel=False)
    while ws.k >= 3:
        e, a = ws.sweep()
        je, ja = jws.sweep()
        np.testing.assert_array_equal(e, np.asarray(je))
        np.testing.assert_array_equal(a, np.asarray(ja))
        assert dataclasses.astuple(ws.evaluate_current()) == \
            dataclasses.astuple(jws.evaluate_current())
        j = int(np.argmin(e))
        ws.descend(j)
        jws.descend(j)


def test_one_launch_sequence_per_warm_descent(graphs):
    _, port = graphs
    cid, props, n_s, am = _class_args(port, "ssn:Observation")
    sweep.clear_compile_cache()
    ws = sweep.DeviceSweepWorkspace(port, cid, props, n_s, am, device="cpu")
    ws.sweep()
    ws.descend(0)
    ws.sweep()
    # one shape: the drop-one stack spans the full column bucket at
    # every descent level
    assert sweep.trace_count() == 1 and sweep.distinct_bucket_shapes() == 1
    assert sweep.lowerings_per_descent() == 1.0
    sweep.reset_trace_stats()
    ws2 = sweep.DeviceSweepWorkspace(port, cid, props, n_s, am, device="cpu")
    ws2.sweep()
    ws2.sweep_candidates(1 - np.eye(n_s, dtype=np.int32)[:3])
    assert sweep.trace_count() == 1          # (n_b, k_b, 4): a new c_b rung
    assert sweep.lowerings_per_descent() == 1.0
    sweep.reset_trace_stats()
    ws2.sweep()
    assert sweep.trace_count() == 0          # warm: no new shape
    assert sweep.EXEC_STATS == {"lowerings": 1, "descents": 1}


def test_chunked_stack_counts_one_launch_per_chunk(graphs):
    _, port = graphs
    cid, props, n_s, am = _class_args(port, "ssn:Observation")
    sweep.reset_trace_stats()
    ws = sweep.DeviceSweepWorkspace(port, cid, props, n_s, am, device="cpu")
    masks = np.ones((sweep.MAX_SWEEP_CANDIDATES + 5, n_s), np.int32)
    edges, amis = ws.sweep_candidates(masks)
    assert edges.shape == (masks.shape[0],) and (amis == amis[0]).all()
    assert sweep.EXEC_STATS == {"lowerings": 2, "descents": 1}
