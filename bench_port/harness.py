"""The benchmark of ``repro_torch``: one run of one cell.

    python bench_port/run.py --workload NAME --seed N --seconds S --trace 0|1

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the schema, scale and guarantees of a deployment, and the generator of
its graphs, ``gen/<generator>.py``, by default ``sensor``) and a traffic
mix (``traffic/<mix>.json``: numbers for one general driver,
``drivers/<driver>.py``); each per-layer metric has a reader of its own,
``metrics/<metric>.py``.  The harness finds all of them by name, so a
later change adds a cell, a mix, a metric or a deployment of another
schema by adding files and entries.

A run: set-up (generate the inputs from the seed, build and warm the
program; ``setup_s`` is the time from the process's start to the
window), the measured window of ``--seconds``, then, with the program's
state released, the plain reference judges what the window produced
(``correct``).  ``--trace 1`` profiles the window and reports the
per-layer metrics instead of the end-to-end ones.  The last stdout line
is the result; the numbers compared, each with its limit, close both it
and standard error.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from .gen.sensor import seeded_rng
from .tracing import KernelArgs, Spans, profiled

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> tuple[dict, dict]:
    """The workload entry and its configuration entry."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    return cell, cfgs[cell["config"]]


def applies(metric: dict, cell: str, reported: set[str]) -> bool:
    """A metric belongs to a cell that its ``workloads`` list names, or,
    without the list, to every cell that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_file(path: Path, mod_name: str):
    """The module of a file found by name (dataclasses in it look their
    module up in ``sys.modules``, so it is registered there)."""
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, here: Path = HERE):
    """``metrics/<name>.py``'s ``read(run)``."""
    return load_file(here / "metrics" / f"{name}.py",
                     f"bench_port_metric_{name.replace('.', '_')}").read


def generator(name: str, here: Path = HERE):
    """``gen/<name>.py``, the generator a configuration names (the
    contract is in ``gen/__init__.py``)."""
    path = here / "gen" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"the configuration names the generator "
                                f"{name!r}, and there is no {path}")
    return load_file(path, f"bench_port_gen_{name}")


def driver(name: str):
    return importlib.import_module(f"bench_port.drivers.{name}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """Everything one run knows: its cell, configuration, generator and
    spec, traffic, device, spans, and what the driver measured."""

    def __init__(self, name, seed, seconds, traced, device, cell, cfg,
                 traffic, control=False, here: Path = HERE):
        self.name, self.seed, self.seconds = name, int(seed), float(seconds)
        self.traced, self.device, self.control = traced, device, control
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.gen = generator(cfg.get("generator", "sensor"), here)
        self.spec = self.gen.spec_from_config(cfg)
        self.spans = Spans(device, traced)
        self.e2e: dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.trace = None
        self.kernel_args: KernelArgs | None = None
        self.layer: dict[str, tuple[float, str]] = {}

    def rng(self, *stream: int) -> np.random.Generator:
        return seeded_rng(self.seed, *stream)


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, *, control: bool = False, bench: dict | None = None,
             t_start: float | None = None,
             here: Path = HERE, root: Path = ROOT) -> dict:
    """One run; returns the result object (``checks`` last) with the
    forbidden modules found after the window under ``_forbidden``."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench if bench is not None else load_bench(root)
    cell, cfg_entry = find_cell(bench, workload)
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (here / "traffic" / f"{cell['traffic']}.json").read_text())
    device = torch.device(device)
    run = Run(workload, seed, seconds, traced, device, cell, cfg, traffic,
              control, here)
    drv = driver(traffic["driver"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = drv.setup(run)
    run.spans.sync()
    setup_s = time.perf_counter() - t_start
    sink: list = []
    args = KernelArgs() if traced and not control else None
    with profiled(traced, sink):
        if args is not None:
            with args:
                drv.window(run, state)
        else:
            drv.window(run, state)
    run.trace = sink[0] if sink else None
    run.kernel_args = args
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    bad = forbidden_modules()
    if traced:           # readers may look at program state: read first
        reported = set(run.e2e) | {"setup_s"}
        for m in bench["per_layer"]:
            if applies(m, workload, reported):
                v = metric_reader(m["name"], here)(run)
                if v is not None:
                    run.layer[m["name"]] = (float(v), m["unit"])
    drv.release(run, state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check(run, state)
    metrics = {}
    if traced:
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in run.layer.items()}
    else:
        values = dict(run.e2e, setup_s=setup_s)
        for m in bench["end_to_end"]:
            if applies(m, workload, set(values)):
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_seconds()
        dev["window_s"] = run.trace.window_seconds
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    out["_forbidden"] = bad
    return out


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="put the cell's control in the program's place")
    args = ap.parse_args(argv)
    import torch
    bench = load_bench()
    cell, _ = find_cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"bench_port: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", control=bool(args.control), bench=bench,
                   t_start=t_start)
    bad = out.pop("_forbidden") or forbidden_modules()
    if bad:
        print(f"bench_port: modules {bad} were loaded in the measured "
              "process; the benchmark runs the port alone", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
