"""Tabulate the dry run's cell JSONs (``launch/dryrun.py``).

The port's copy of ``repro/launch/report.py``, over the port's cells:

    python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
        [--mesh single|multi|1x1] [--reanalyze]

``reanalyze`` re-runs ``roofline.analyze`` over each cell's saved
per-device counts and collectives (where the JAX version re-reads saved
HLO), after a change to the roofline's peaks or formulas; nothing is
counted again.  The table is a reckoning from shapes and the H100's
published peaks, not a measurement.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .dryrun import OUT_DIR


def load(d: str) -> list[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("tag"):
            continue
        rows.append(r)
    return rows


def fmt_cell(r: dict) -> dict:
    roof = r["roofline"]
    m = roof["memory_analysis"]
    return {
        "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
        "peak_GB": m["peak_bytes"] / 2**30,
        "compute_s": roof["compute_s"], "memory_s": roof["memory_s"],
        "collective_s": roof["collective_s"],
        "bottleneck": roof["bottleneck"],
        "model_flops": roof["model_flops"],
        "useful": roof["useful_flops_ratio"],
        "frac": roof["roofline_fraction"],
    }


def markdown(rows: list[dict], mesh: str = "single") -> str:
    out = ["| arch | shape | peak GB/dev | compute s | memory s | "
           "collective s | bottleneck | MODEL_FLOPS | useful ratio | "
           "roofline frac |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                       f"SKIP (sub-quadratic gate) | — | — | — |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                       f"{r['status'].upper()} | — | — | — |")
            continue
        c = fmt_cell(r)
        out.append(
            f"| {c['arch']} | {c['shape']} | {c['peak_GB']:.2f} | "
            f"{c['compute_s']:.4g} | {c['memory_s']:.4g} | "
            f"{c['collective_s']:.4g} | {c['bottleneck']} | "
            f"{c['model_flops']:.3g} | {c['useful']:.3f} | "
            f"{c['frac']:.4f} |")
    return "\n".join(out)


def summary(rows: list[dict]) -> str:
    ok = [r for r in rows if r["status"] == "ok"]
    skip = [r for r in rows if r["status"] == "skip"]
    bad = [r for r in rows if r["status"] not in ("ok", "skip")]
    lines = [f"cells: {len(ok)} ok, {len(skip)} skip (long_500k x "
             f"full-attention archs), {len(bad)} failed"]
    for r in bad:
        lines.append(f"  FAILED {r['arch']} {r['shape']} {r['mesh']}: "
                     f"{str(r.get('error'))[:120]}")
    return "\n".join(lines)


def reanalyze(d: str) -> int:
    """Re-run ``roofline.analyze`` over every ``ok`` cell's saved counts,
    collectives and MODEL_FLOPS (the cell's own, overrides and all);
    rewrites the cells.  Returns how many."""
    from . import roofline as rl

    n = 0
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if rec.get("status") != "ok":
            continue
        old = rec["roofline"]
        roof = rl.analyze(rec["counts"], old["collectives"]["list"],
                          n_chips=rec["n_chips"],
                          model_flops=old["model_flops"])
        rec["roofline"] = roof.to_json()
        with open(f, "w") as fh:
            json.dump(rec, fh, indent=1)
        n += 1
    print(f"re-analyzed {n} cells")
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--reanalyze", action="store_true")
    args = ap.parse_args(argv)
    if args.reanalyze:
        reanalyze(args.dir)
    rows = load(args.dir)
    print(summary(rows))
    print()
    print(markdown(rows, args.mesh))


if __name__ == "__main__":
    main()
