#!/usr/bin/env python3
"""Drive the repro_torch main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py                       # the full run, one card
    python3 chip_smoke.py --n-triples 200000    # a short rehearsal

Phases, each an assertion (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   from ``src/repro_torch/kernels/csrc`` (``kernels/build.py``);
2. kernel parity: ``sig_hash`` and ``seg_count`` against their plain
   torch versions on the card, bit for bit, over ragged N, several K,
   ``-1`` rows, the (N, K), (C, N, K) and fused parent + column-mask
   forms, and ``valid`` of shape (N,) and (C, N);
3. the main path on the sensor workload (``generate_workload``,
   10M triples by default): ``Compactor("gfsp", "device")`` and
   ``Compactor("efsp", "device")`` on the card against
   ``Compactor("gfsp", "host")`` -- identical plans and G', a lossless
   digest, ``validate()``, one launch sequence per warm descent;
4. star queries: ``QueryEngine.query_batch(backend="device")`` over 64
   queries built from the molecule tables, each answer identical to
   ``eval_raw`` on the original store;
5. each kernel's launches on the main path, its time beside its plain
   version's, its bound and a library yardstick, at the main path's
   shapes.

The last two lines are the ``{"kernels": [...]}`` record and the
``{"ok": true, "device": ...}`` line.  Without CUDA, or without the
package beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# lane rate of one 64-lane/clk/SM integer pipe, half the float32 lanes of
# the 67 TFLOP/s FMA figure (2 flops per FMA).  Integer work goes to two
# such pipes at once: IMAD to the FMA pipe, shifts and logic
# (SHF/LOP3/IADD3) to the INT32 ALU pipe; the busier pipe sets the floor.
HBM_BYTES_PER_S = 3.35e12
INT32_PIPE_OPS_PER_S = 67e12 / 2 / 2

N_QUERIES = 64
SEED = 0

# kernel parity: ragged row counts and column counts (bucket rungs and not)
PARITY_N = (1, 1000, (1 << 21) + 3)
PARITY_K = (2, 3, 8, 32)


def log(msg: str) -> None:
    print(msg, flush=True)


def sha1(arr) -> str:
    import numpy as np
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_diff(a, b) -> int:
    """Largest integer difference between two equally shaped results
    (uint32 lanes compared as unsigned values)."""
    import torch
    if a.dtype == torch.uint32:
        a = a.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        b = b.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# ---------------------------------------------------------------------------
# phase 2: kernel parity
# ---------------------------------------------------------------------------

# per kernel: largest difference from its plain version, cases checked
ERR = {"sig_hash": 0, "seg_count": 0}
CASES = {"sig_hash": 0, "seg_count": 0}


def parity_case(mat, kw: dict, what: str, seg: bool = True) -> None:
    """``sig_hash(mat, **kw)`` against its plain version on the same
    inputs and, with ``seg``, ``seg_count`` on the sorted result against
    its own; any difference fails the run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.seg_count import (seg_boundaries,
                                               seg_boundaries_plain)
    from repro_torch.kernels.sig_hash import sig_hash, sig_hash_plain

    sig = sig_hash(mat, **kw)
    pairs = [("sig_hash", sig, sig_hash_plain(mat, **kw), "")]
    if seg:
        srt, _ = ops.sort_signatures(sig)
        (b, c), (pb, pc) = seg_boundaries(srt), seg_boundaries_plain(srt)
        pairs += [("seg_count", b, pb, " bounds"),
                  ("seg_count", c, pc, " counts")]
    torch.cuda.synchronize()
    for name, got, want, part in pairs:
        e = max_abs_diff(got, want)
        assert e == 0, f"{name} disagrees with its plain version: {what}{part}"
        ERR[name] = max(ERR[name], e)
        CASES[name] += 1


def kernel_parity(dev) -> None:
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    c = 3
    for n in PARITY_N:
        for k in PARITY_K:
            mat = rng.integers(-2**31, 2**31, (n, k), dtype=np.int64)
            mat[::7] = -1                                 # pad rows
            mat[1::5] = mat[0]                            # repeated rows
            mat = torch.from_numpy(mat.astype(np.int32)).to(dev)
            stack = torch.from_numpy(rng.integers(
                -1, 50, (c, n, k)).astype(np.int32)).to(dev)
            masks = torch.from_numpy(
                rng.integers(0, 2, (c, k)).astype(np.int32)).to(dev)
            v_n = torch.from_numpy(rng.random(n) < 0.9).to(dev)
            v_cn = torch.from_numpy(rng.random((c, n)) < 0.9).to(dev)
            cases = [("(N,K)", mat, {}),
                     ("(N,K) valid (N,)", mat, {"valid": v_n}),
                     ("(C,N,K)", stack, {}),
                     ("(C,N,K) valid (C,N)", stack, {"valid": v_cn}),
                     ("parent+masks valid (N,)", mat,
                      {"valid": v_n, "col_masks": masks}),
                     ("parent+masks valid (C,N)", mat,
                      {"valid": v_cn, "col_masks": masks})]
            for what, a, kw in cases:
                parity_case(a, kw, f"{what} N={n} K={k}")
    log(f"parity: sig_hash {CASES['sig_hash']} cases, seg_count "
        f"{CASES['seg_count']} cases, all bit-exact")


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

def reset_launches() -> None:
    from repro_torch.kernels import seg_count, sig_hash
    sig_hash.launches = 0
    seg_count.launches = 0


def read_launches() -> dict[str, int]:
    from repro_torch.kernels import seg_count, sig_hash
    return {"sig_hash": sig_hash.launches, "seg_count": seg_count.launches}


def plan_rows(report):
    out = []
    for e in report.plan:
        d = e.detection
        out.append((e.class_id, e.props, d.edges, d.ami, d.evaluations,
                    d.iterations, e.predicted_edges, e.baseline_edges))
    return out


def compaction(store, totals) -> tuple:
    import torch
    from repro_torch.api import Compactor
    from repro_torch.core import sweep

    runs = {}
    for det, be in (("gfsp", "device"), ("efsp", "device"), ("gfsp", "host")):
        comp = Compactor(det, be)
        sweep.reset_trace_stats()
        reset_launches()
        t0 = time.perf_counter()
        plan = comp.plan(store)              # detection (the sweeps)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        report = comp.execute(store, plan)   # factorization (host)
        secs = time.perf_counter() - t0
        launched = read_launches()
        shapes = sorted(k for k in sweep.TRACE_COUNTS)
        if be == "device":
            for name, n in launched.items():
                assert n > 0, f"{name} was not launched by {det}/{be}"
                totals[name] += n
        log(f"main path {det}/{be}: {secs:.2f} s (plan {t_plan:.2f} s, "
            f"execute {secs - t_plan:.2f} s), launches {launched}, "
            f"bucket shapes {shapes}, lowerings/descent "
            f"{sweep.lowerings_per_descent():.3f}, "
            f"triples {report.n_triples_before} -> {report.n_triples_after}")
        for row in plan_rows(report):
            log(f"  class {row[0]}: SP {row[1]} edges {row[2]} ami {row[3]} "
                f"evaluations {row[4]} iterations {row[5]}")
        runs[(det, be)] = (comp, report, shapes)
    return runs


def check_compaction(store, runs):
    from repro_torch.core import sweep

    gd_comp, gd, _ = runs[("gfsp", "device")]
    ed_comp, ed, _ = runs[("efsp", "device")]
    gh_comp, gh, _ = runs[("gfsp", "host")]
    assert plan_rows(gd) == plan_rows(gh), "gfsp device != host plan"
    assert [(e.class_id, e.props, e.detection.edges) for e in ed.plan] == \
        [(e.class_id, e.props, e.detection.edges) for e in gd.plan], \
        "efsp SP/edges != gfsp"
    assert gd.plan.entries, "nothing was compacted"
    g_sha = {k: sha1(r[1].graph.spo) for k, r in runs.items()}
    assert len(set(g_sha.values())) == 1, f"G' differs: {g_sha}"
    in_sha = sha1(store.spo)
    digest = gd_comp.snapshot.digest()
    assert digest == in_sha[:16], "digest != sha1(input spo): lossy"
    gd_comp.fgraph.validate()
    log(f"compaction checks: plans equal, G' sha1 {g_sha[('gfsp', 'host')]} "
        f"on all three, digest {digest} == sha1(input)[:16], validate ok")

    # warm second gfsp detection: no new bucket shape, one launch
    # sequence per descent
    sweep.reset_trace_stats()
    t0 = time.perf_counter()
    warm = gd_comp.plan(store)
    secs = time.perf_counter() - t0
    lpd = sweep.lowerings_per_descent()
    assert [(e.class_id, e.props) for e in warm] == \
        [(e.class_id, e.props) for e in gd.plan]
    assert lpd == 1.0, f"lowerings per warm descent {lpd}"
    assert sweep.trace_count() == 0, dict(sweep.TRACE_COUNTS)
    log(f"warm gfsp/device detection: {secs:.2f} s, lowerings/descent "
        f"{lpd}, new bucket shapes 0")
    return gd_comp


def build_queries(store, fg, n_queries: int):
    import numpy as np
    from repro_torch.query import StarQuery

    rng = np.random.default_rng(SEED)
    idx = store.index
    queries = []
    tables = sorted(fg.tables.items())
    classes = [int(c) for c in store.classes()]
    i = 0
    while len(queries) < n_queries:
        cid, t = tables[i % len(tables)]
        kind = (i // len(tables)) % 4
        i += 1
        r = int(rng.integers(0, t.n_molecules))
        row = t.objects[r]
        ground = [(p, int(o)) for p, o in zip(t.props, row)]
        outside = [int(p) for p in store.class_properties(cid)
                   if int(p) not in t.props]
        if kind == 0:                        # every SP arm ground
            arms = ground
        elif kind == 1:                      # SP prefix ground + var arm
            arms = ground[:-1] + [(t.props[-1], None)]
        elif kind == 2 and outside:          # ground arm outside SP
            member = int(fg.members(int(t.surrogates[r]))[0])
            sl = idx.pred_slice(outside[0])
            j = int(np.searchsorted(sl[:, 0], member))
            arms = ground[:1] + [(outside[0], int(sl[j, 2]))]
        elif kind == 2:                      # miss
            arms = [(t.props[0], int(store.dict.lookup("rdf:type")))]
        else:                                # SP arm + var arm outside SP
            arms = ground[:1] + ([(outside[-1], None)] if outside
                                 else [(t.props[-1], None)])
        queries.append(StarQuery(arms=tuple(arms), class_id=cid))
    assert all(c in classes for c in (q.class_id for q in queries))
    return queries


def star_queries(store, fg, totals):
    """Phase 4; returns the engine (its uploaded molecule tables) and the
    query bucket shapes it launched."""
    import torch
    from repro_torch.core import sweep
    from repro_torch.query import QueryEngine, eval_raw

    queries = build_queries(store, fg, N_QUERIES)
    eng = QueryEngine(fg)
    sweep.reset_trace_stats()
    reset_launches()
    t0 = time.perf_counter()
    got = eng.query_batch(queries, backend="device")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = read_launches()
    assert launched["sig_hash"] > 0, "query path did not launch sig_hash"
    for name, n in launched.items():
        totals[name] += n
    rows = 0
    for q, b in zip(queries, got):
        want = eval_raw(store, q)
        assert b.same_as(want), f"query {q} differs from eval_raw"
        rows += b.n_rows
    shapes = sorted(sweep.TRACE_COUNTS)
    log(f"queries: {len(queries)} star queries via query_batch(device) in "
        f"{secs:.2f} s, launches {launched}, bucket shapes {shapes}, "
        f"{rows} binding rows, all identical to eval_raw on the original "
        "store")
    return eng, shapes


# ---------------------------------------------------------------------------
# phase 5: parity and timing at the main path's shapes
# ---------------------------------------------------------------------------

def main_path_parity(store, eng, shapes, dev):
    """Each kernel against its plain version at every bucket shape the
    main path launched, on the main path's own data: each class's real
    parent buffer with its drop-one stack (gfsp) or seeded 0/1 masks
    over its columns (the wider efsp levels), and each uploaded molecule
    table with masks and values of its own molecules (queries, which
    launch ``sig_hash`` only).  Returns the inputs of the widest gfsp
    sweep, the shape the timings use."""
    import numpy as np
    import torch
    from repro_torch.core.sweep import (DeviceSweepWorkspace, bucket_cols,
                                        bucket_rows)

    rng = np.random.default_rng(SEED)
    sweeps = [s[1:] for s in shapes if s[0] == "sweep"]
    buckets = {(n_b, k_b) for n_b, k_b, _ in sweeps}
    parents = {}
    for cid in (int(c) for c in store.classes()):
        stats = store.class_stats(cid)
        props = tuple(int(p) for p in stats.properties)
        ws = DeviceSweepWorkspace(store, cid, props, len(props),
                                  stats.n_instances, device=dev)
        key = (bucket_rows(ws.matrix.shape[0]), bucket_cols(len(props)))
        if props and key in buckets and key not in parents:
            ws._ensure_uploaded()
            parents[key] = ws
    assert set(parents) == buckets, (sorted(buckets), sorted(parents))

    timed = None
    for n_b, k_b, c_b in sweeps:
        ws = parents[(n_b, k_b)]
        k = ws.matrix.shape[1]
        stack = np.zeros((c_b, k_b), np.int32)
        if c_b == k_b:                   # the gfsp drop-one sweep
            stack[:, :k] = ws._drop_one_stack(c_b)
        else:                            # an efsp lattice level
            stack[:, :k] = rng.integers(0, 2, (c_b, k))
        kw = {"valid": ws._valid,
              "col_masks": torch.from_numpy(stack).to(dev)}
        parity_case(ws._dev, kw, f"sweep ({n_b}, {k_b}) x {c_b}")
        if c_b == k_b and (timed is None or n_b * k_b > timed[0].numel()):
            timed = (ws._dev, kw)
    assert timed is not None, "no gfsp sweep on the main path"

    for _, m_b, k_b, q_b in (s for s in shapes if s[0] == "query"):
        buf = next(b for b in eng._bufs.values()
                   if (b.m_bucket, b.k_bucket) == (m_b, k_b))
        masks = np.zeros((q_b, k_b), np.int32)
        masks[:, :buf.k] = rng.integers(0, 2, (q_b, buf.k))
        vals = np.zeros((q_b, k_b), np.int32)
        vals[:, :buf.k] = buf.dev[torch.from_numpy(
            rng.integers(0, buf.m, q_b)), :buf.k].cpu().numpy()
        masks = torch.from_numpy(masks).to(dev)
        vals = torch.from_numpy(vals).to(dev)
        parity_case(buf.dev, {"valid": buf.valid, "col_masks": masks},
                    f"query table ({m_b}, {k_b}) x {q_b}", seg=False)
        parity_case((vals * masks)[:, None, :], {},
                    f"query tuples ({q_b}, 1, {k_b})", seg=False)
    log(f"main-path parity: sweep shapes {sweeps}, query shapes "
        f"{[s[1:] for s in shapes if s[0] == 'query']}; totals sig_hash "
        f"{CASES['sig_hash']} cases, seg_count {CASES['seg_count']} cases, "
        "all bit-exact")
    return timed


def kernel_times(parent, kw) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.seg_count import (seg_boundaries,
                                               seg_boundaries_plain)
    from repro_torch.kernels.sig_hash import sig_hash, sig_hash_plain

    n_b, k_b = parent.shape
    c_b = kw["col_masks"].shape[0]
    srt, _ = ops.sort_signatures(sig_hash(parent, **kw))
    s32 = srt.view(torch.int32)

    out = {}
    sig_bytes = n_b * k_b * 4 + c_b * k_b * 4 + n_b + c_b * n_b * 8
    # per row and column, both lanes: 3 IMAD + 3 ALU (mul, rotl, mul;
    # xor, rotl, mul-add) per lane, plus the mask multiply (IMAD) and
    # the hi lane's seed xor (ALU); per lane fmix32(h ^ K): 2 IMAD, 7 ALU
    sig_imad = c_b * n_b * (7 * k_b + 4)
    sig_alu = c_b * n_b * (7 * k_b + 14)
    out["sig_hash"] = dict(
        shape=f"parent ({n_b}, {k_b}) int32, masks ({c_b}, {k_b}), "
              f"valid ({n_b},) -> ({c_b}, {n_b}, 2) uint32",
        ms=time_ms(lambda: sig_hash(parent, **kw)),
        plain_ms=time_ms(lambda: sig_hash_plain(parent, **kw), 5, 1),
        library_ms=None,
        bound=(sig_bytes / HBM_BYTES_PER_S * 1e3,
               max(sig_imad, sig_alu) / INT32_PIPE_OPS_PER_S * 1e3))
    seg_bytes = c_b * n_b * 8 + c_b * n_b * 4 + c_b * 4
    seg_ops = c_b * n_b * 4
    out["seg_count"] = dict(
        shape=f"sorted ({c_b}, {n_b}, 2) uint32 -> ({c_b}, {n_b}) int32 "
              f"+ ({c_b},) int32",
        ms=time_ms(lambda: seg_boundaries(srt)),
        plain_ms=time_ms(lambda: seg_boundaries_plain(srt)),
        library_ms=time_ms(lambda: torch.any(
            s32[..., 1:, :] != s32[..., :-1, :], dim=-1)),
        bound=(seg_bytes / HBM_BYTES_PER_S * 1e3,
               seg_ops / INT32_PIPE_OPS_PER_S * 1e3))
    for name, rec in out.items():
        by_bytes, by_ops = rec.pop("bound")
        rec["bound_ms"] = max(by_bytes, by_ops)
        rec["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        log(f"timing {name} at {rec['shape']}: kernel {rec['ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms'] if rec['library_ms'] is None else round(rec['library_ms'], 4)} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; bytes "
            f"{by_bytes:.4f} ms, operations {by_ops:.4f} ms)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-triples", type=int, default=10_000_000)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)

    # phase 1: the card and the build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"kernels built from {build.CSRC.relative_to(ROOT)} "
        f"({', '.join(build.SOURCES)}) -> {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # phase 2
    t0 = time.perf_counter()
    kernel_parity(dev)
    log(f"parity phase: {time.perf_counter() - t0:.1f} s")

    # phase 3
    from repro_torch.data.synthetic import WorkloadSpec, generate_workload
    t0 = time.perf_counter()
    store = generate_workload(WorkloadSpec(shape="sensor",
                                           n_triples=args.n_triples,
                                           seed=SEED))
    log(f"workload: sensor, n_triples target {args.n_triples}, "
        f"{store.n_triples} triples, {len(store.dict)} terms, generated in "
        f"{time.perf_counter() - t0:.1f} s")
    totals = {"sig_hash": 0, "seg_count": 0}
    runs = compaction(store, totals)
    gd_comp = check_compaction(store, runs)

    # phase 4
    eng, q_shapes = star_queries(store, gd_comp.fgraph, totals)

    # phase 5
    shapes = sorted({s for r in runs.values() for s in r[2]} | set(q_shapes))
    times = kernel_times(*main_path_parity(store, eng, shapes, dev))
    src = "src/repro_torch/kernels/csrc/"
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src + f"{name}.cu",
         "replaces": replaces, "launches": totals[name],
         "max_abs_err": ERR[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"]}
        for name, replaces in (("sig_hash", "src/repro/kernels/sig_hash.py:61"),
                               ("seg_count",
                                "src/repro/kernels/seg_count.py:46"))]}
    for k in record["kernels"]:
        assert k["launches"] > 0 and k["max_abs_err"] == 0, k
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
