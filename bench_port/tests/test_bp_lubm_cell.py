"""``lubm-10.compact-efsp`` on a small checkout: LUBM at one university
through the cell's own mix, configuration and readers, the program's
device path on its plain CPU kernels."""
import json

import pytest

from conftest import ROOT, run_small, small_checkout

CELL = "lubm-10.compact-efsp"
READERS = ("fold_ms.compact-efsp", "sweep_ms.compact-efsp",
           "sweep_kept_pct.compact-efsp")


@pytest.fixture
def root(tmp_path):
    """The benchmark with LUBM(1) in place of LUBM(10) and a pool of two
    graphs, two of them judged."""
    root = small_checkout(tmp_path)
    here = root / "bench_port"
    path = here / "configs" / "lubm-10.json"
    cfg = json.loads(path.read_text())
    cfg["n_universities"] = 1
    path.write_text(json.dumps(cfg))
    path = here / "traffic" / "compact-efsp.json"
    mix = json.loads(path.read_text())
    mix.update(pool=2, check_ops=2)
    path.write_text(json.dumps(mix))
    return root


def test_the_cell_is_declared_with_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("lubm-10", "compact-efsp", 1)
    mix = json.loads((ROOT / "bench_port" / "traffic" /
                      "compact-efsp.json").read_text())
    assert mix["detector"] == "efsp"
    cfg = json.loads((ROOT / "bench_port" / "configs" /
                      "lubm-10.json").read_text())
    assert (cfg["generator"], cfg["n_universities"]) == ("lubm", 10)
    for name in READERS:
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert m["workloads"] == [CELL]
        assert (ROOT / "bench_port" / "metrics" / f"{name}.py").exists()


def test_the_cell_is_correct_on_the_program(root):
    out = run_small(root, seed=2**31 + 41, seconds=1.0, cell=CELL)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"compact_triples_per_s", "setup_s"}
    assert out["checks"]["plan_fields_wrong"]["value"] == 0


def test_a_traced_run_reads_every_new_metric(root):
    out = run_small(root, seed=2**31 + 41, seconds=1.0, traced=True,
                    cell=CELL)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(READERS)
    # partial entity sets are scored: some hashed rows count toward no AMI
    assert 0 < out["metrics"]["sweep_kept_pct.compact-efsp"]["value"] < 100


def test_the_control_is_not_correct(root):
    out = run_small(root, seed=2**31 + 41, seconds=1.0, control=True,
                    cell=CELL)
    assert not out["correct"], out["checks"]
