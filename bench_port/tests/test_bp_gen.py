"""The inputs repeat per seed, the graph is the port's ``generate``'s,
and a configuration file gives the spec it states."""
import json

import numpy as np
import pytest

from bench_port.gen import sensor as S
from conftest import ROOT

SPEC = S.SensorSpec(n_observations=1500, n_sensors=20, n_timestamps=50,
                    n_values=40)


def _graph(seed, spec=SPEC):
    v = S.Vocabulary(spec)
    return v, S.graph_rows(v, spec, S.seeded_rng(seed))


@pytest.mark.parametrize("meta", [False, True])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_graph_equals_the_ports_generate(seed, meta):
    from repro_torch.data.synthetic import SensorGraphSpec, generate
    spec = S.SensorSpec(300, 12, 30, 25, include_sensor_metadata=meta)
    v, rows = _graph(seed, spec)
    mine = {tuple(v.terms[i] for i in r) for r in rows.tolist()}
    store = generate(SensorGraphSpec(
        n_observations=300, n_sensors=12, n_timestamps=30, n_values=25,
        seed=seed, include_sensor_metadata=meta))
    assert mine == set(store.triples_as_terms())
    assert len(mine) == rows.shape[0]


@pytest.mark.parametrize("seed", [3, -1, 10**12])
def test_graph_repeats_per_seed(seed):
    assert np.array_equal(_graph(seed)[1], _graph(seed)[1])
    assert not np.array_equal(_graph(seed)[1], _graph(seed + 1)[1])


def test_the_configuration_file_gives_its_spec():
    cfg = json.loads((ROOT / "bench_port" / "configs" /
                      "lsd-d1d2d3.json").read_text())
    spec = S.SensorSpec.from_config(cfg)
    assert spec == S.SensorSpec(200_000, 200, 200_000, 400, 1.8, False)
    v = S.Vocabulary(spec)
    rows = S.graph_rows(v, spec, S.seeded_rng(2**31 + 11))
    assert rows.shape == (9 * 200_000, 3)
    assert rows.shape[0] == cfg["shape"]["triples"]
    # near-unique sampling times: an instant holds Poisson(1) observations
    times = rows[rows[:, 1] == v.id(S.P_TIME), 2]
    _, per = np.unique(times, return_counts=True)
    assert per.max() <= 12 and 0.6 < per.shape[0] / 200_000 < 0.66
