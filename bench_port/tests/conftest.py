"""CPU tests of the benchmark (``python -m pytest bench_port/tests``): the
harness, the generator and the reference at small sizes, with the
port's device path on its plain CPU kernels.  Tests that need the card
are marked ``cuda`` and decide inside the test whether one is there."""
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELL = "lsd-d1d2d3.compact"


def small_checkout(tmp: Path, n_observations: int = 3000,
                   n_sensors: int = 20, n_values: int = 40, pool: int = 2,
                   check_ops: int = 2) -> Path:
    """A checkout of the benchmark whose configuration and mix are cut to
    a few thousand observations, so every layer runs in seconds; the
    harness runs it with ``root=`` and ``here=``."""
    root = tmp / "checkout"
    here = root / "bench_port"
    shutil.copytree(ROOT / "bench_port", here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    path = here / "configs" / "lsd-d1d2d3.json"
    cfg = json.loads(path.read_text())
    cfg["n_observations"] = n_observations
    cfg["assumed"].update(n_sensors=n_sensors, n_values=n_values)
    path.write_text(json.dumps(cfg))
    path = here / "traffic" / "compact.json"
    mix = json.loads(path.read_text())
    mix.update(pool=pool, check_ops=check_ops)
    path.write_text(json.dumps(mix))
    return root


def run_small(root: Path, seed: int = 11, seconds: float = 2.0,
              traced: bool = False, control: bool = False,
              device: str = "cpu", cell: str = CELL) -> dict:
    from bench_port import harness
    return harness.run_cell(cell, seed, seconds, traced, device,
                            control=control,
                            bench=harness.load_bench(root),
                            here=root / "bench_port", root=root)
