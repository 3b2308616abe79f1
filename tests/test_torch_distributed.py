"""The port's sharded detection against the JAX package's on the same
inputs: ``ami_bucketed_batch`` and ``ami_bucketed`` on 1-, 4- and
(4, 2) data x model meshes (a ``cap_factor`` small enough that buckets
overflow included, so the dropped-signature correction is held to JAX's
count), ``ShardedBackend`` gfsp and efsp on a (4, 2) mesh and with
``mesh=None``, ``ShardedSweepWorkspace.sweep_candidates`` at several
bucket shapes, and ``cross_shard_ami`` -- every number integer-exact.

The JAX side needs an 8-device host platform, so it runs once, in a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
that prints its results as JSON (the ``J`` fixture).  The port's meshes
hold ``cpu`` in every entry: the plain versions of the kernels, one
process, the exchange a permutation of host tensors."""
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import (CompactionPlanner, Compactor, ShardedBackend,
                             get_backend)
from repro_torch.core import sweep as tsweep
from repro_torch.core.distributed import (EXCHANGE_STATS, ami_bucketed,
                                          ami_bucketed_batch, dp_devices,
                                          eval_subset_device,
                                          gfsp_distributed, pad_rows,
                                          shard_rows, sweep_drop_one)
from repro_torch.core.star import ami
from repro_torch.core.sweep import ShardedSweepWorkspace
from repro_torch.data.synthetic import SensorGraphSpec, generate
from repro_torch.dist.graph import ShardedFactorizedGraph
from repro_torch.dist.mesh import make_mesh, make_test_mesh
from repro_torch.dist.sharding import batch_axes_for, make_plan

ROOT = Path(__file__).resolve().parents[1]

# the inputs both sides build from the same seeds (exec'd here and in
# the JAX subprocess, so the two cannot drift apart)
_INPUTS = r'''
import numpy as np

MESHES = {"1": ((1,), ("data",)), "4": ((4,), ("data",)),
          "4x2": ((4, 2), ("data", "model"))}
# (n, k, card, C): ragged row counts, narrow and wide cardinality
AMI_CASES = [(1000, 4, 13, 5), (97, 3, 2, 3), (4096, 2, 300, 4)]
# the case each mesh is held to JAX on (a JAX call compiles anew, ~7 s)
MESH_CASE = {"1": 1, "4": 0, "4x2": 2}
# 4.0 is the default headroom (exact: held to the host count); 0.3 makes
# most buckets overflow (held to JAX's count)
CAPS = (4.0, 0.3)
OVERFLOW_CAP = 0.3
SWEEP_OBS = (40, 1500)               # Observation rows: 64/2048 buckets
SWEEP_CANDS = (1, 40, 300)           # 300 > MAX_SWEEP_CANDIDATES: chunked


def ami_inputs(case_i):
    n, k, card, c = AMI_CASES[case_i]
    rng = np.random.default_rng(100 + case_i)
    mat = rng.integers(0, card, (n, k)).astype(np.int32)
    masks = rng.integers(0, 2, (c, k)).astype(np.int32)
    masks[0] = 1                     # the all-columns candidate
    return mat, masks


def sweep_masks(n_cols, c, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (c, n_cols)).astype(np.int32)
'''
exec(_INPUTS)

_JAX = _INPUTS + r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys, json, types
import jax, jax.numpy as jnp
sys.path.insert(0, "src")
from repro.api import Compactor, ShardedBackend
from repro.core import sweep as jsweep
from repro.core.distributed import ami_bucketed_batch, pad_rows, shard_rows
from repro.core.sweep import ShardedSweepWorkspace
from repro.data.synthetic import SensorGraphSpec, generate
from repro.dist.graph import ShardedFactorizedGraph
from repro.dist.sharding import make_plan
from repro.launch.mesh import make_mesh_compat

# one part per process (the fixture runs them side by side)
part = sys.argv[1]
out = {}
if part.startswith("ami:"):
    name = part[4:]
    shape, axes = MESHES[name]
    mesh = make_mesh_compat(shape, axes)
    mat, masks = ami_inputs(MESH_CASE[name])
    padded, n_real = pad_rows(mat, shape[0])
    dev = shard_rows(padded, mesh)
    valid = jnp.arange(padded.shape[0]) < n_real
    with mesh:
        got = ami_bucketed_batch(dev, valid, jnp.asarray(masks), mesh,
                                 dp_axes=("data",), cap_factor=OVERFLOW_CAP)
    out[f"ami/{name}"] = [int(x) for x in got]

mesh = make_mesh_compat((4, 2), ("data", "model"))
if part == "backend":
    out["backend"] = {}
    store = generate(SensorGraphSpec(n_observations=403, seed=2))
    for det in ("gfsp", "efsp"):
        jsweep.clear_compile_cache()
        comp = Compactor(detector=det, backend=ShardedBackend(mesh=mesh))
        rep = comp.run(store)
        out["backend"][det] = {
            "plan": [[e.class_id, list(e.props), e.predicted_edges,
                      e.baseline_edges, list(e.detection.props),
                      e.detection.edges, e.detection.ami,
                      e.detection.evaluations, e.detection.iterations]
                     for e in rep.plan],
            "n_after": rep.n_triples_after, "digest": comp.snapshot.digest(),
            "exec": dict(jsweep.EXEC_STATS),
            "traces": sorted([list(k) for k in jsweep.TRACE_COUNTS])}

if part == "sweep":
    out["sweep"] = {}
    plan = make_plan(types.SimpleNamespace(tp=True, fsdp=False,
                                           seq_shard=False), mesh)
    for n_obs in SWEEP_OBS:
        st = generate(SensorGraphSpec(n_observations=n_obs, seed=3))
        cid = st.dict.lookup("ssn:Observation")
        stats = st.class_stats(cid)
        props = sorted(int(p) for p in stats.properties)
        jsweep.clear_compile_cache()
        ws = ShardedSweepWorkspace(st, cid, props, len(props),
                                   stats.n_instances, mesh=mesh, plan=plan)
        res = {"drop_one": [x.tolist() for x in ws.sweep()]}
        for c in SWEEP_CANDS:
            e, a = ws.sweep_candidates(sweep_masks(len(props), c, n_obs + c))
            res[str(c)] = [e.tolist(), a.tolist()]
        ws.descend(1)
        res["descended"] = [x.tolist() for x in ws.sweep()]
        res["exec"] = dict(jsweep.EXEC_STATS)
        res["traces"] = sorted([list(k) for k in jsweep.TRACE_COUNTS])
        res["dp_axes"] = list(ws.dp_axes)
        out["sweep"][str(n_obs)] = res

if part == "cross":
    st = generate(SensorGraphSpec(n_observations=400, seed=7))
    sh = ShardedFactorizedGraph.partition(st, 4, oversplit=4)
    out["cross"] = {"amis": {str(c): sh.cross_shard_ami(c, mesh=mesh)
                             for c in sh.plan.split_classes},
                    "traffic": dict(sh.traffic)}
print(json.dumps(out))
'''


# each JAX call of the exchange compiles anew, so the parts run side by
# side in processes of their own
_PARTS = ("ami:1", "ami:4", "ami:4x2", "backend", "sweep", "cross")


@pytest.fixture(scope="module")
def J():
    """The JAX package's results on an 8-device host platform."""
    pytest.importorskip("jax")
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, part],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=ROOT) for part in _PARTS]
    out = {}
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-3000:]
            out.update(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    return out


def _mesh(name):
    shape, axes = MESHES[name]
    return make_test_mesh(shape, axes)


# ---------------------------------------------------------------------------
# meshes and the planner
# ---------------------------------------------------------------------------

def test_mesh_holds_torch_devices_in_its_shape():
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (4, 2) and mesh.shape == {"data": 4,
                                                           "model": 2}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    seq = make_mesh((2,), ("data",), ["cpu", torch.device("cpu")])
    assert seq.devices.shape == (2,)
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data",), "cpu")
    with pytest.raises(ValueError):
        make_mesh((3,), ("data",), ["cpu", "cpu"])


def test_a_cuda_mesh_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((4,), ("data",))                 # cuda:0 by default
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((2,), ("data",), ["cpu", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedBackend()                           # mesh=None: on cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Compactor("gfsp", "sharded")


def test_plan_reserves_the_model_axis_and_ladders_the_batch():
    from repro.dist.sharding import make_plan as jax_make_plan
    tp = types.SimpleNamespace(tp=True, fsdp=False, seq_shard=False)
    plan = make_plan(make_test_mesh((4, 2), ("data", "model")))
    assert plan.dp_axes == ("data",)
    assert plan.ladder == (("data",), ())
    assert batch_axes_for(plan, 64) == ("data",)
    assert batch_axes_for(plan, 6) == ()
    pod = make_plan(make_test_mesh((2, 2, 2), ("pod", "data", "model")))
    assert pod.dp_axes == ("pod", "data")
    assert pod.ladder == (("pod", "data"), ("data",), ())
    assert batch_axes_for(pod, 4) == ("pod", "data")
    assert batch_axes_for(pod, 6) == ("data",)
    assert batch_axes_for(pod, 3) == ()
    # the same layout as repro's planner with tensor parallel on
    for shape, axes in (((4, 2), ("data", "model")), ((8,), ("data",)),
                        ((2, 2, 2), ("pod", "data", "model")),
                        ((2, 4), ("pod", "data")), ((2, 3), ("model", "data"))):
        mesh = make_test_mesh(shape, axes)
        got, want = make_plan(mesh), jax_make_plan(tp, mesh)
        assert (got.axis_sizes, got.dp_axes, got.ladder) == \
            (want.axis_sizes, want.dp_axes, want.ladder), axes
        for batch in (1, 2, 3, 4, 6, 8, 12, 64):
            assert batch_axes_for(got, batch) == batch_axes_for(want, batch)
    be = get_backend("sharded", mesh=make_test_mesh((4, 2)))
    assert be.name == "sharded" and be.plan.dp_axes == ("data",)


def test_dp_devices_and_shard_rows_follow_the_dp_axes():
    mesh = make_mesh((2, 3), ("model", "data"),
                     [torch.device("cpu")] * 6)
    assert len(dp_devices(mesh, ("data",))) == 3
    assert len(dp_devices(mesh, ("data", "model"))) == 6
    mat = np.arange(24, dtype=np.int32).reshape(12, 2)
    blocks = shard_rows(mat, mesh)           # every axis but "model"
    assert [b.shape[0] for b in blocks] == [4, 4, 4]
    assert np.array_equal(np.concatenate([b.numpy() for b in blocks]), mat)
    with pytest.raises(ValueError, match="pad_rows"):
        shard_rows(mat[:11], mesh)


# ---------------------------------------------------------------------------
# the bucketed exchange
# ---------------------------------------------------------------------------

def _ami_inputs(mesh_name, case_i):
    mat, masks = ami_inputs(case_i)
    padded, n_real = pad_rows(mat, MESHES[mesh_name][0][0])
    valid = np.arange(padded.shape[0]) < n_real
    exact = [ami(mat[:, m.astype(bool)]) if m.any() else 1 for m in masks]
    return mat, masks, padded, valid, exact


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_ami_bucketed_batch_equals_jax_with_overflow(J, mesh_name):
    case_i = MESH_CASE[mesh_name]
    mat, masks, padded, valid, exact = _ami_inputs(mesh_name, case_i)
    mesh = _mesh(mesh_name)
    n_dp = MESHES[mesh_name][0][0]
    for cap in CAPS:
        EXCHANGE_STATS.update(calls=0, bytes=0, dropped=0)
        got = ami_bucketed_batch(padded, valid, masks, mesh,
                                 dp_axes=("data",), cap_factor=cap)
        assert got.dtype == torch.int32 and got.shape == (masks.shape[0],)
        assert got.tolist() == (J[f"ami/{mesh_name}"] if cap == OVERFLOW_CAP
                                else exact), cap
        # overflow only ever adds: the count is an upper bound, and it
        # is exact where nothing overflowed
        assert all(g >= e for g, e in zip(got.tolist(), exact))
        assert (EXCHANGE_STATS["dropped"] > 0) == (got.tolist() != exact)
        slots = max(int(cap * padded.shape[0] / n_dp / n_dp) + 8, 8)
        assert EXCHANGE_STATS["calls"] == 1
        assert EXCHANGE_STATS["bytes"] == \
            n_dp * n_dp * masks.shape[0] * slots * 8
    assert J[f"ami/{mesh_name}"] != exact   # the headroom overflowed


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case_i", range(len(AMI_CASES)))
def test_ami_bucketed_batch_is_exact_at_default_headroom(mesh_name, case_i):
    mat, masks, padded, valid, exact = _ami_inputs(mesh_name, case_i)
    got = ami_bucketed_batch(padded, valid, masks, _mesh(mesh_name))
    assert got.tolist() == exact


def test_ami_bucketed_on_placed_blocks():
    mat, masks, padded, valid, exact = _ami_inputs("4", MESH_CASE["4"])
    mesh = _mesh("4")
    blocks, vblocks = shard_rows(padded, mesh), shard_rows(valid, mesh)
    assert [b.shape[0] for b in blocks] == [padded.shape[0] // 4] * 4
    assert int(ami_bucketed(blocks, vblocks, mesh)) == ami(mat)
    # the all-ones first candidate is the C = 1 count, at any headroom
    assert int(ami_bucketed(blocks, vblocks, mesh, cap_factor=0.3)) == \
        int(ami_bucketed_batch(padded, valid, masks, mesh,
                               cap_factor=0.3)[0])


def test_ami_bucketed_rejects_mismatched_shards():
    mesh = _mesh("4")
    mat = np.zeros((8, 2), np.int32)
    with pytest.raises(ValueError, match="shards"):
        ami_bucketed(shard_rows(mat, _mesh("1")), np.ones(8, bool), mesh)


def test_sweep_drop_one_equals_host():
    rng = np.random.default_rng(5)
    mat = rng.integers(0, 4, (300, 4)).astype(np.int32)
    padded, n = pad_rows(mat, 64)
    valid = torch.arange(padded.shape[0]) < n
    edges, amis = sweep_drop_one(torch.from_numpy(padded), valid, 300, 6)
    want = [ami(np.delete(mat, j, axis=1)) for j in range(4)]
    assert amis.tolist() == want
    assert edges.tolist() == [a * 4 + 300 * (6 - 3) for a in want]


def test_eval_subset_device_equals_host():
    rng = np.random.default_rng(6)
    mat = rng.integers(0, 3, (100, 3)).astype(np.int32)
    padded, n = pad_rows(mat, 64)
    valid = torch.arange(padded.shape[0]) < n
    edges, a = eval_subset_device(torch.from_numpy(padded), valid, 100, 3,
                                  5)
    assert int(a) == ami(mat) and int(edges) == ami(mat) * 4 + 100 * 2


# ---------------------------------------------------------------------------
# the sharded backend and its sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", [None, "4x2"])
def test_gfsp_distributed_equals_host(mesh_name):
    store = generate(SensorGraphSpec(n_observations=150, seed=8))
    cid = store.dict.lookup("ssn:Observation")
    host = Compactor("gfsp", "host").detect(store, cid)
    got = gfsp_distributed(store, cid, device="cpu", mesh=None
                           if mesh_name is None else _mesh(mesh_name))
    assert (got.props, got.edges, got.ami, got.evaluations) == \
        (host.props, host.edges, host.ami, host.evaluations)


def _plan_rows(rep):
    return [[e.class_id, list(e.props), e.predicted_edges,
             e.baseline_edges, list(e.detection.props), e.detection.edges,
             e.detection.ami, e.detection.evaluations,
             e.detection.iterations] for e in rep.plan]


@pytest.mark.parametrize("detector", ["gfsp", "efsp"])
def test_sharded_backend_on_a_4x2_mesh_equals_jax_and_host(J, detector):
    store = generate(SensorGraphSpec(n_observations=403, seed=2))
    host = Compactor(detector, "host")
    host_rep = host.run(store)
    tsweep.clear_compile_cache()
    comp = Compactor(detector, ShardedBackend(mesh=_mesh("4x2")))
    rep = comp.run(store)
    want = J["backend"][detector]
    assert comp.backend.plan.dp_axes == ("data",)
    assert _plan_rows(rep) == want["plan"] == _plan_rows(host_rep)
    assert rep.n_triples_after == want["n_after"]
    assert comp.snapshot.digest() == want["digest"] == \
        host.snapshot.digest()
    assert dict(tsweep.EXEC_STATS) == want["exec"]
    assert sorted(list(k) for k in tsweep.TRACE_COUNTS) == want["traces"]


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    from repro.api import Compactor as JCompactor
    from repro.data import synthetic as jsyn
    return types.SimpleNamespace(Compactor=JCompactor, syn=jsyn)


@pytest.mark.parametrize("detector", ["gfsp", "efsp"])
def test_sharded_backend_without_a_mesh_equals_jax(R, detector):
    ref = R.syn.generate(R.syn.SensorGraphSpec(n_observations=300, seed=4))
    jrep = R.Compactor(detector, "sharded").run(ref)
    store = generate(SensorGraphSpec(n_observations=300, seed=4))
    be = ShardedBackend(device="cpu")
    assert be.mesh is None and be.plan is None
    rep = Compactor(detector, be).run(store)
    assert _plan_rows(rep) == _plan_rows(jrep)
    assert rep.graph.spo.tobytes() == jrep.graph.spo.tobytes()
    rep2 = Compactor(detector, "sharded",
                     backend_opts={"device": "cpu"}).run(store)
    assert _plan_rows(rep2) == _plan_rows(jrep)


@pytest.mark.parametrize("n_obs", SWEEP_OBS)
def test_sweep_candidates_at_several_bucket_shapes_equal_jax(J, n_obs):
    want = J["sweep"][str(n_obs)]
    st = generate(SensorGraphSpec(n_observations=n_obs, seed=3))
    cid = st.dict.lookup("ssn:Observation")
    stats = st.class_stats(cid)
    props = sorted(int(p) for p in stats.properties)
    mesh = _mesh("4x2")
    plan = make_plan(mesh)
    tsweep.clear_compile_cache()
    ws = ShardedSweepWorkspace(st, cid, props, len(props),
                               stats.n_instances, mesh=mesh, plan=plan)
    assert [x.tolist() for x in ws.sweep()] == want["drop_one"]
    for c in SWEEP_CANDS:
        e, a = ws.sweep_candidates(sweep_masks(len(props), c, n_obs + c))
        assert [e.tolist(), a.tolist()] == want[str(c)], c
    ws.descend(1)
    assert [x.tolist() for x in ws.sweep()] == want["descended"]
    assert dict(tsweep.EXEC_STATS) == want["exec"]
    assert sorted(list(k) for k in tsweep.TRACE_COUNTS) == want["traces"]
    assert list(ws.dp_axes) == want["dp_axes"]
    # the parent uploaded once, one equal row block per DP coordinate
    assert len(ws._dev) == 4
    assert {b.shape for b in ws._dev} == {(ws.n_bucket // 4, ws.k_bucket)}


# ---------------------------------------------------------------------------
# cross-shard AMI
# ---------------------------------------------------------------------------

def test_cross_shard_ami_on_a_mesh_equals_jax(J):
    st = generate(SensorGraphSpec(n_observations=400, seed=7))
    sh = ShardedFactorizedGraph.partition(st, 4, oversplit=4)
    assert sh.plan.split_classes
    mesh = _mesh("4x2")
    got = {str(c): sh.cross_shard_ami(c, mesh=mesh)
           for c in sh.plan.split_classes}
    assert got == J["cross"]["amis"]
    assert sh.traffic == J["cross"]["traffic"]
    assert got == {str(c): sh.cross_shard_ami(c)
                   for c in sh.plan.split_classes}   # the host count
    report = sh.detect_all(backend="host", mesh=mesh)
    assert {str(c): a for c, a in report["split_class_ami"].items()} == got
    assert sh.traffic["collective_calls"] == 2 * len(got)
    snap, _ = CompactionPlanner("gfsp", "host").run(st.copy())
    assert sh.digest() == snap.digest()
