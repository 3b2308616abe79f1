"""``BENCH_fsp.json``'s four 100k ``shard_matrix`` cells, rebuilt on the
port as ``benchmarks/shard_cell.py`` builds them: the sensor workload
(seed 7), a replicated host compaction, a partition into 1, 2, 4 or 8
shards at oversplit 4, shard-local host detection (fork-parallel on
more than one shard), the chunk-split classes' AMI through the hash-
bucket exchange on a CPU mesh of that many entries, and the 64 star
queries through the fan-out engine on the device path (the CPU's plain
versions), cold and warm.  The digests, ``collective_ami``, ``traffic``,
``shard_weights``, ``split_classes`` and resident bytes must equal the
recorded values -- the reference's own numbers, so no jax is needed."""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch.api import CompactionPlanner
from repro_torch.data.synthetic import WorkloadSpec, generate_workload
from repro_torch.dist.graph import ShardedFactorizedGraph, ShardedQueryEngine
from repro_torch.dist.mesh import make_mesh
from repro_torch.query import StarQuery

ROOT = Path(__file__).resolve().parents[1]
CELLS = {c["devices"]: c for c in json.loads(
    (ROOT / "BENCH_fsp.json").read_text())["shard_matrix"]["cells"]
    if c["n_triples"] == 99_999}


def _store():
    return generate_workload(WorkloadSpec(shape="sensor",
                                          n_triples=100_000, seed=7))


def _build_queries(fg, max_lookups: int = 24, max_var: int = 8):
    """``shard_cell._build_queries``: full lookups and a ground arm with
    a variable arm from each class's first molecules."""
    queries = []
    for cid, t in sorted(fg.tables.items()):
        for row in t.objects[:max_lookups]:
            queries.append(StarQuery(
                arms=tuple((int(p), int(o)) for p, o in zip(t.props, row)),
                class_id=cid))
        for row in t.objects[:max_var]:
            queries.append(StarQuery(
                arms=((int(t.props[0]), int(row[0])),
                      (int(t.props[-1]), None)),
                class_id=cid))
    return queries


def _digest(bindings) -> str:
    h = hashlib.sha1()
    for b in bindings:
        h.update(np.ascontiguousarray(b.canonical()).tobytes())
    return h.hexdigest()[:16]


@pytest.fixture(scope="module")
def replicated():
    store = _store()
    snap, rep = CompactionPlanner("gfsp", "host").run(store.copy())
    return snap, rep


def test_the_recorded_cells_are_there():
    assert sorted(CELLS) == [1, 2, 4, 8]


@pytest.mark.parametrize("devices", [1, 2, 4, 8])
def test_shard_matrix_cell_reproduces_the_record(replicated, devices):
    want = CELLS[devices]
    snap, rep = replicated
    store = _store()
    assert store.n_triples == want["n_triples"]
    assert snap.digest() == want["detect_digest"]
    assert round(float(rep.pct_savings_triples), 2) == \
        want["pct_savings_repl"]

    sharded = ShardedFactorizedGraph.partition(store, devices, oversplit=4)
    report = sharded.detect_all(backend="host", parallel=devices > 1)
    assert sharded.digest() == want["detect_digest"]
    assert len(sharded.plan.split_classes) == want["split_classes"]
    assert [int(w) for w in sharded.plan.shard_weights] == \
        want["shard_weights"]
    assert sharded.shard_nbytes() == want["shard_resident_bytes"]

    collective = {}
    if devices > 1:
        mesh = make_mesh((devices,), ("data",), "cpu")
        for cid in sharded.plan.split_classes:
            got = sharded.cross_shard_ami(cid, mesh=mesh)
            assert got == report["split_class_ami"][int(cid)]
            collective[store.dict.term(cid)] = got
    assert collective == want["collective_ami"]

    queries = _build_queries(snap.fgraph)
    assert len(queries) == want["n_queries"]
    eng = ShardedQueryEngine(sharded, device="cpu")
    cold = eng.query_batch(queries, backend="device")
    warm = eng.query_batch(queries, backend="device")
    assert _digest(cold) == _digest(warm) == want["query_digest"]
    assert sum(b.n_rows for b in warm) == want["query_rows"]
    assert {k: int(v) for k, v in sharded.traffic.items()} == \
        want["traffic"]
