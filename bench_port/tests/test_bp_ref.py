"""At small sizes the plain reference equals the port's host backend:
plans, G' rows and molecule tables, and its expansion of G' gives the
input back."""
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


def _port_snapshot(v, rows):
    from repro_torch.api import Compactor
    from repro_torch.convert import store_from_arrays
    comp = Compactor("gfsp", "host")
    rep = comp.run(store_from_arrays(v.terms, rows))
    return comp, rep


# 50 instants: times shared by many observations; 2000: near-unique, as
# the configuration draws them
@pytest.mark.parametrize("seed,meta,n_timestamps",
                         [(1, False, 50), (2, True, 50), (3, False, 50),
                          (4, False, 2000)])
def test_compaction_reference_equals_the_host_backend(seed, meta,
                                                      n_timestamps):
    _, v, rows = _graph(seed, meta, n_timestamps=n_timestamps)
    comp, rep = _port_snapshot(v, rows)
    plan, gp, tables = _reference(v.terms, rows)
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
