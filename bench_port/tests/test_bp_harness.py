"""The harness end to end on the CPU: the cell found by name, a cell, a
mix and a metric added as files, a configuration of another schema with
its own generator added as files, the cell correct on the program, its
control and every planted fault not correct, the result line's shape,
and the isolation rules."""
import json
import shutil
import subprocess
import sys

import pytest

from bench_port import harness
from conftest import CELL, ROOT, run_small, small_checkout


@pytest.fixture
def root(tmp_path):
    return small_checkout(tmp_path)


def test_the_cell_is_correct_on_the_program(root):
    out = run_small(root)
    assert out["correct"], out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert [k for k in out if not k.startswith("_")][-1] == "checks"
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"compact_triples_per_s", "setup_s"}
    assert out["checks"]["plan_fields_wrong"] == {"value": 0, "limit": 0}


def test_the_traced_cell_reports_its_per_layer_metrics(root):
    out = run_small(root, traced=True)
    bench = harness.load_bench(root)
    want = {m["name"] for m in bench["per_layer"]
            if CELL in m.get("workloads", ())}
    # the card's own readings (idle share, rooflines) need the card
    cpu = {n for n in want if "idle" not in n and "roofline" not in n}
    assert cpu and cpu <= set(out["metrics"]) <= want, out["metrics"]
    assert out["correct"] and "window_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_control_is_not_correct(tmp_path):
    # enough molecules for a 16-bit hash to merge some
    root = small_checkout(tmp_path, n_observations=20000, n_sensors=200)
    out = run_small(root, control=True)
    assert not out["correct"], out["checks"]


def _fault_unchanged(mp):
    from repro_torch.api import snapshot
    mp.setattr(snapshot, "factorize_classes", lambda store, pairs, **kw:
               (store, []))


def _fault_altered(mp):
    from repro_torch.api import snapshot
    real = snapshot.factorize_classes

    def altered(store, pairs, **kw):
        g, res = real(store, pairs, **kw)
        g.spo[0, 2] = g.spo[1, 2] if g.spo[1, 2] != g.spo[0, 2] else 0
        return g, res
    mp.setattr(snapshot, "factorize_classes", altered)


@pytest.mark.parametrize("fault", [_fault_unchanged, _fault_altered],
                         ids=["state-unchanged", "answer-altered"])
def test_a_planted_fault_is_not_correct(fault, root, monkeypatch):
    fault(monkeypatch)
    out = run_small(root)
    assert not out["correct"], out["checks"]


def test_a_cell_mix_and_metric_added_as_files(root):
    here = root / "bench_port"
    cfg = json.loads((here / "configs" / "lsd-d1d2d3.json").read_text())
    cfg["name"] = "lsd-small"
    cfg["n_observations"] = 800
    cfg["assumed"]["n_sensors"] = 10
    (here / "configs" / "lsd-small.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "compact.json").read_text())
    mix.update(pool=3, check_ops=1)
    (here / "traffic" / "compact-three.json").write_text(json.dumps(mix))
    (here / "metrics" / "ops.compact-three.py").write_text(
        "def read(run):\n    return len(run.spans.seconds['op'])\n")
    b = harness.load_bench(root)
    b["configs"].append({"name": "lsd-small", "source": "test",
                         "file": "bench_port/configs/lsd-small.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "lsd-small.compact-three",
                           "config": "lsd-small", "traffic": "compact-three",
                           "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "ops.compact-three", "unit": "count",
                           "better": "higher", "source": "host_clock",
                           "layer": "planner, detectors and sweep",
                           "moves": "compact_triples_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = "lsd-small.compact-three"
    # the rate's workloads list does not name the cell yet
    out = run_small(root, seed=3, seconds=1.0, cell=cell)
    assert out["correct"] and set(out["metrics"]) == {"setup_s"}
    _admit_rate(root, cell)
    out = run_small(root, seed=3, seconds=1.0, cell=cell)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"compact_triples_per_s", "setup_s"}
    out = run_small(root, seed=3, seconds=1.0, traced=True, cell=cell)
    assert out["correct"] and out["metrics"]["ops.compact-three"]["value"] > 0
    assert out["checks"]["ops_checked_missing"]["value"] == 0
    # metrics whose workloads list names another cell stay out
    assert "detect_ms.compact" not in out["metrics"]


def _admit_rate(root, cell):
    """Append ``cell`` to ``compact_triples_per_s``'s workloads list."""
    b = harness.load_bench(root)
    rate = next(m for m in b["end_to_end"]
                if m["name"] == "compact_triples_per_s")
    rate["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(b))


# A generator of another schema, kept to the contract of gen/__init__.py:
# Course (dept, level, room: complete, functional molecules that repeat)
# and Student (major, year and either a functional college or, where the
# configuration says "multi_valued", 1-3 takes: multi-valued, and an
# advisor on one in five: optional).
TOY_GENERATOR = """\
import numpy as np

PREDS = ("dept", "level", "room", "major", "year", "college", "takes",
         "advisor")
SIZES = {"dept": 5, "level": 3, "room": 4, "major": 6, "year": 4,
         "college": 3, "prof": 10}


def spec_from_config(cfg):
    return (int(cfg["n_courses"]), int(cfg["n_students"]),
            bool(cfg["multi_valued"]))


class Vocabulary:
    def __init__(self, spec):
        n_courses, n_students, _ = spec
        terms = ["rdf:type", "repro:instanceOf", "Course", "Student",
                 *PREDS]
        self.id = {t: i for i, t in enumerate(terms)}
        self.start = {}
        for block, n in (*SIZES.items(), ("course", n_courses),
                         ("student", n_students)):
            self.start[block] = len(terms)
            terms += [f"{block}/{i}" for i in range(n)]
        self.terms = terms


def graph_rows(vocab, spec, rng):
    n_courses, n_students, multi_valued = spec
    st, v = vocab.start, vocab.id

    def arm(s, p, o):
        return np.stack([s, np.full(len(s), v[p]), o], 1)

    c = st["course"] + np.arange(n_courses)
    s = st["student"] + np.arange(n_students)
    parts = [arm(c, "rdf:type", np.full(len(c), v["Course"])),
             arm(s, "rdf:type", np.full(len(s), v["Student"]))]
    if multi_valued:
        takes = np.repeat(s, rng.integers(1, 4, n_students))
        adv = s[rng.random(n_students) < 0.2]
        parts += [arm(takes, "takes",
                      st["course"] + rng.integers(0, n_courses, len(takes))),
                  arm(adv, "advisor",
                      st["prof"] + rng.integers(0, SIZES["prof"], len(adv)))]
    student = ("major", "year") + (() if multi_valued else ("college",))
    for ents, props in ((c, ("dept", "level", "room")), (s, student)):
        parts += [arm(ents, p, st[p] + rng.integers(0, SIZES[p], len(ents)))
                  for p in props]
    return np.concatenate(parts).astype(np.int32)
"""


@pytest.mark.parametrize("schema", ["functional", "multi_valued"])
def test_a_configuration_of_another_schema_added_as_files(root, monkeypatch,
                                                          schema):
    here = root / "bench_port"
    (here / "gen" / "toy.py").write_text(TOY_GENERATOR)
    (here / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "generator": "toy", "n_courses": 300,
         "n_students": 900, "multi_valued": schema == "multi_valued",
         "guarantees": {"lossless": "expand(G') equals the input graph"}}))
    shutil.copy(here / "metrics" / "detect_ms.compact.py",
                here / "metrics" / "detect_ms.toy.py")
    b = harness.load_bench(root)
    b["configs"].append({"name": "toy", "source": "test",
                         "file": "bench_port/configs/toy.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "toy.compact", "config": "toy",
                           "traffic": "compact", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "detect_ms.toy", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "planner, detectors and sweep",
                           "moves": "compact_triples_per_s",
                           "workloads": ["toy.compact"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    _admit_rate(root, "toy.compact")
    # the program's detectors still score a star on the entities complete
    # over all of the class's properties, the reference on the entities
    # the star folds: on a multi-valued or optional property the plans
    # part, and the harness's own check says so
    sound = schema == "functional"
    out = run_small(root, seed=2**31 + 3, seconds=1.0, cell="toy.compact")
    assert out["correct"] is sound, out["checks"]
    assert (out["checks"]["plan_fields_wrong"]["value"] > 0) is not sound
    assert set(out["metrics"]) == {"compact_triples_per_s", "setup_s"}
    assert out["checks"]["ops_checked_missing"]["value"] == 0
    out = run_small(root, seed=2**31 + 3, seconds=1.0, traced=True,
                    cell="toy.compact")
    # the *.compact metrics name the sensor cell alone: only its own
    assert out["correct"] is sound
    assert set(out["metrics"]) == {"detect_ms.toy"}
    _fault_altered(monkeypatch)
    out = run_small(root, seed=2**31 + 3, seconds=1.0, cell="toy.compact")
    assert not out["correct"], out["checks"]


def _subprocess(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_module_of_jax_or_the_jax_package_is_loaded(root):
    code = (
        "import sys, json; sys.path[:0] = ['.', 'src', 'bench_port/tests']\n"
        "from pathlib import Path\n"
        "from conftest import run_small\n"
        f"out = run_small(Path({str(root)!r}), seed=5, seconds=1.0,"
        " traced=True)\n"
        "assert out['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    r = _subprocess(code)
    assert r.returncode == 0, r.stderr[-2000:]
    loaded = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_a_run_without_a_card_exits_non_zero_with_no_result():
    r = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        CELL, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_a_checkout_of_the_benchmark_alone_exits_non_zero(tmp_path):
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        CELL, "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
