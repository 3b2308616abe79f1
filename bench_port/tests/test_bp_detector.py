"""A traffic mix names its detector: without the key the cell runs
``gfsp`` as it always has, and a mix naming ``efsp`` drives the
program's exhaustive detector and has the reference judge it with its
own E.FSP."""
import hashlib
import json

import numpy as np
import pytest
import torch

from bench_port import harness
from bench_port.drivers import compact
from bench_port.ref import fsp
from conftest import CELL, ROOT, run_small, small_checkout

# traffic/compact.json as the lsd-d1d2d3.compact cell has always read it
COMPACT_JSON_SHA256 = \
    "8038b33f6bcc516aab62e98af5557730cb39659d0b181613369051bf97bbfcbc"


@pytest.fixture
def root(tmp_path):
    return small_checkout(tmp_path)


@pytest.fixture
def detectors(monkeypatch):
    """The detector of every ``Compactor`` the program builds, and the
    algorithm of every reference plan."""
    import repro_torch.api as api
    seen = {"program": [], "reference": []}
    real, real_plan = api.Compactor, fsp.plan

    def compactor(detector, *a, **kw):
        seen["program"].append(detector)
        return real(detector, *a, **kw)

    def plan(*a, **kw):
        seen["reference"].append(kw.get("detector", "gfsp"))
        return real_plan(*a, **kw)
    monkeypatch.setattr(api, "Compactor", compactor)
    monkeypatch.setattr(fsp, "plan", plan)
    return seen


def _add_mix(root, name, **numbers):
    """A mix ``name`` (the compact mix with ``numbers``) and its cell on
    the small checkout's configuration."""
    here = root / "bench_port"
    mix = json.loads((here / "traffic" / "compact.json").read_text())
    (here / "traffic" / f"{name}.json").write_text(
        json.dumps(dict(mix, **numbers)))
    b = harness.load_bench(root)
    cell = f"lsd-d1d2d3.{name}"
    b["workloads"].append({"name": cell, "config": "lsd-d1d2d3",
                           "traffic": name, "chips": 1, "why": "test"})
    next(m for m in b["end_to_end"]
         if m["name"] == "compact_triples_per_s")["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return cell


def test_the_compact_mix_names_no_detector():
    raw = (ROOT / "bench_port" / "traffic" / "compact.json").read_bytes()
    assert "detector" not in json.loads(raw)
    assert hashlib.sha256(raw).hexdigest() == COMPACT_JSON_SHA256


def test_a_mix_without_a_detector_runs_gfsp(root, detectors):
    out = run_small(root)
    assert out["correct"], out["checks"]
    assert set(detectors["program"]) == {"gfsp"}
    assert set(detectors["reference"]) == {"gfsp"}


def _first_op(root, cell):
    """The program's op on the first graph of the cell's pool."""
    bench = harness.load_bench(root)
    entry, cfg_entry = harness.find_cell(bench, cell)
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "bench_port" / "traffic" /
                          f"{entry['traffic']}.json").read_text())
    run = harness.Run(cell, 17, 1.0, False, torch.device("cpu"), entry, cfg,
                      traffic, here=root / "bench_port")
    state = compact.setup(run)
    return state["op"](state["vocab"].terms, state["pool"][0], run.device,
                       run.spans)


def test_naming_gfsp_gives_what_naming_none_gives(root):
    cell = _add_mix(root, "compact-gfsp", detector="gfsp")
    (rows_a, gp_a, tab_a), (rows_b, gp_b, tab_b) = (
        _first_op(root, CELL), _first_op(root, cell))
    assert rows_a == rows_b and np.array_equal(gp_a, gp_b)
    assert sorted(tab_a) == sorted(tab_b)
    for cid, (props, sg, objs) in tab_a.items():
        assert tuple(props) == tuple(tab_b[cid][0])
        assert np.array_equal(sg, tab_b[cid][1])
        assert np.array_equal(objs, tab_b[cid][2])


def test_a_mix_naming_efsp_runs_and_is_judged_by_efsp(root, detectors):
    cell = _add_mix(root, "compact-efsp", detector="efsp")
    out = run_small(root, seed=2**31 + 21, seconds=1.0, cell=cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["ops_checked_missing"]["value"] == 0
    assert set(detectors["program"]) == {"efsp"}
    assert set(detectors["reference"]) == {"efsp"}
    # the two algorithms count their work apart, so the plan fields tell
    # a run judged by the other one
    rows, _, _ = _first_op(root, cell)
    g_rows, _, _ = _first_op(root, CELL)
    assert [r[4:6] for r in rows] != [r[4:6] for r in g_rows]


def test_the_control_under_efsp_is_not_correct(tmp_path):
    root = small_checkout(tmp_path, n_observations=20000, n_sensors=200)
    cell = _add_mix(root, "compact-efsp", detector="efsp")
    out = run_small(root, seconds=1.0, control=True, cell=cell)
    assert not out["correct"], out["checks"]
