"""At small sizes the plain reference equals the port's host backend
with either detector: plans, G' rows and molecule tables, and its
expansion of G' gives the input back; and on sensor graphs, whose
properties are all functional and complete, it gives what the reference
gave before it scored a pattern on the entities it folds."""
import hashlib

import numpy as np
import pytest

from bench_port.drivers.compact import _reference
from bench_port.gen import sensor as S
from bench_port.ref import fsp
from bench_port.ref.graph import rows_diff, sort_unique


def _graph(seed, meta=False, n=2000, n_timestamps=50):
    spec = S.SensorSpec(n, 20, n_timestamps, 40,
                        include_sensor_metadata=meta)
    v = S.Vocabulary(spec)
    return spec, v, S.graph_rows(v, spec, S.seeded_rng(seed))


def _port_snapshot(v, rows, detector="gfsp"):
    from repro_torch.api import Compactor
    from repro_torch.convert import store_from_arrays
    comp = Compactor(detector, "host")
    rep = comp.run(store_from_arrays(v.terms, rows))
    return comp, rep


# 50 instants: times shared by many observations; 2000: near-unique, as
# the configuration draws them
@pytest.mark.parametrize("detector", ["gfsp", "efsp"])
@pytest.mark.parametrize("seed,meta,n_timestamps",
                         [(1, False, 50), (2, True, 50), (3, False, 50),
                          (4, False, 2000)])
def test_compaction_reference_equals_the_host_backend(seed, meta,
                                                      n_timestamps,
                                                      detector):
    _, v, rows = _graph(seed, meta, n_timestamps=n_timestamps)
    comp, rep = _port_snapshot(v, rows, detector)
    plan, gp, tables = _reference(v.terms, rows, detector=detector)
    assert plan == [(e.class_id, tuple(e.props), e.detection.edges,
                     e.detection.ami, e.detection.evaluations,
                     e.detection.iterations, e.predicted_edges,
                     e.baseline_edges) for e in rep.plan]
    assert rows_diff(sort_unique(rep.graph.spo), gp) == 0
    assert sorted(tables) == sorted(rep.fgraph.tables)
    for cid, (props, sg, objs) in tables.items():
        t = rep.fgraph.tables[cid]
        assert tuple(props) == t.props
        assert np.array_equal(sg, t.surrogates)
        assert np.array_equal(objs, t.objects)
    assert rows_diff(fsp.expand(rep.graph.spo, 0, 1), sort_unique(rows)) == 0


# sha256 of the plan rows, G' rows and molecule tables that the reference
# gave before it scored a pattern on the entities it folds (Def. 4.8 over
# the entities complete over S), exact and with the control's 16-bit
# grouping: (seed, sensor metadata, instants, observations, bits)
BEFORE_SHA256 = {
    (1, False, 50, 2000, 64):
        "9af40e644a165ee971b04484e0061e501bda0767a3094319d4974dfb9ab44b9b",
    (1, False, 50, 2000, 16):
        "8a042a8ab78bd051fcc60488cf6dfefaae0473cb68834a32560afc35699209a1",
    (2, True, 50, 2000, 64):
        "2bf693c08ea5b9b3b1e692d86e064fd7bebae99e70e294df538a3fe4c49384d4",
    (2, True, 50, 2000, 16):
        "e41d66544063c2a7e7ba5af0a6f64ed8be34c5c5c6153cccce63d3705f6d47db",
    (3, False, 2000, 2000, 64):
        "0f8a51dbecde7efca67acf3432d3a91206297de6f62eeff853d54314d282b4cd",
    (3, False, 2000, 2000, 16):
        "cd82f75f072ab9d43b29ab38a68243b5ec72de0a11c97d3ee325ed2aa299e689",
    (2**31 + 9, True, 3000, 3000, 64):
        "0362bcb483d6c5ce3dec6f310c0a33f942722b09c1950a6f7dd805301ab3584e",
    (2**31 + 9, True, 3000, 3000, 16):
        "b414a4e3b393e62d5f09830d38d6ba1ac48c80a12b5586d1ab89eec63c85dc4e",
}


def reference_digest(terms, rows, sig_bits, detector="gfsp"):
    plan, gp, tables = _reference(terms, rows, sig_bits=sig_bits,
                                  detector=detector)
    h = hashlib.sha256(repr(plan).encode())
    h.update(np.ascontiguousarray(gp, np.int64).tobytes())
    for cid in sorted(tables):
        props, sg, objs = tables[cid]
        h.update(repr(tuple(props)).encode())
        h.update(np.ascontiguousarray(sg, np.int64).tobytes())
        h.update(np.ascontiguousarray(objs, np.int64).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("key", sorted(BEFORE_SHA256))
def test_the_reference_on_sensor_graphs_is_as_before(key):
    seed, meta, n_timestamps, n, bits = key
    _, v, rows = _graph(seed, meta, n, n_timestamps)
    assert reference_digest(v.terms, rows, bits) == BEFORE_SHA256[key]
