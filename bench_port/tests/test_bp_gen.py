"""The inputs repeat per seed, the graph is the port's ``generate``'s,
a configuration file gives the spec it states, the harness builds the
sensor pool through the generator the configuration names (by default
``sensor``) byte for byte as before, and a generator without a file
fails at set-up."""
import dataclasses
import hashlib
import json
import re

import numpy as np
import pytest

from bench_port import harness
from bench_port.drivers import compact
from bench_port.gen import sensor as S
from conftest import CELL, ROOT, run_small, small_checkout

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


def _set_up_run(root, seed):
    """The cell's ``Run`` as ``run_cell`` makes it, before set-up."""
    import torch
    bench = harness.load_bench(root)
    cell, entry = harness.find_cell(bench, CELL)
    cfg = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "bench_port" / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    return harness.Run(CELL, seed, 1.0, False, torch.device("cpu"), cell,
                       cfg, traffic, here=root / "bench_port")


# sha256 of the term list and the pool's rows, as the harness and driver
# of the tree before configurations named their generators built them
POOL_SHA256 = {
    11: "5ac489323b6f9258aaf7198aa863ba38be204e556505a4f535c35545c0e74c58",
    2**31 + 7:
        "38ee97c610ed01a1400a5a134e76eddd80cf815aa5de21845d82a2925858edcf",
}


@pytest.mark.parametrize("seed", sorted(POOL_SHA256))
def test_the_harness_builds_the_sensor_pool_as_before(seed, tmp_path):
    run = _set_up_run(small_checkout(tmp_path), seed)
    assert run.gen.__file__.endswith("sensor.py")
    state = compact.setup(run)
    spec = S.SensorSpec.from_config(run.cfg)
    v = S.Vocabulary(spec)
    assert dataclasses.astuple(run.spec) == dataclasses.astuple(spec)
    assert state["vocab"].terms == v.terms
    direct = [S.graph_rows(v, spec, S.seeded_rng(seed, 1, j))
              for j in range(len(state["pool"]))]
    assert len(direct) == 2
    digest = hashlib.sha256("\n".join(v.terms).encode())
    for got, want in zip(state["pool"], direct):
        assert got.dtype == np.int32 and np.array_equal(got, want)
        digest.update(np.ascontiguousarray(got).tobytes())
    assert digest.hexdigest() == POOL_SHA256[seed]


def test_a_configuration_naming_a_missing_generator_fails_at_set_up(
        tmp_path):
    root = small_checkout(tmp_path)
    path = root / "bench_port" / "configs" / "lsd-d1d2d3.json"
    cfg = json.loads(path.read_text())
    path.write_text(json.dumps(dict(cfg, generator="nosuch")))
    missing = root / "bench_port" / "gen" / "nosuch.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(missing))):
        run_small(root)
