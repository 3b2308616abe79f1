#!/usr/bin/env python3
"""Time repro_torch's ``linear_scan`` on one NVIDIA GPU at the serve
path's scan shapes.

    python3 tools/time_scan.py [ROOT] [--stages N]

``ROOT`` is a checkout that holds ``src/repro_torch`` (by default the one
this script lies in), so the kernels of two trees can be timed on the
same card, each in its own process: run A, B, B, A and compare within
the call.  ``--stages N`` builds the scan with a cp.async ring of N
stages (``-DLINEAR_SCAN_STAGES=N``, a library of its own) in place of
the kernel's 4.

The shapes are recurrentgemma-2b's RG-LRU scans on the serve path: the
flat prefill (8, 2304, 2560), the batch-1 molecule prefill (1, 2048,
2560) and a decode step (8, 1, 2560) with h0, float32 inputs made from
seed 0.  Each is checked bit for bit against the plain version, then
timed two ways: CUDA events around 50 back-to-back calls of the wrapper
(five repeats after 5 warm-up calls; at the decode shape this is the
wrapper's host time, which hides the kernel), and the kernel's own
device time per launch from ``torch.profiler`` over 50 calls.  Prints
the card's name and power limit, then one JSON line per shape.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = [(8, 2304, 2560, False), (1, 2048, 2560, False), (8, 1, 2560, True)]
REPEATS, ITERS, WARMUP = 5, 50, 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--stages", type=int, default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("time_scan: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_plain
    if args.stages is not None:
        build.NVCC_FLAGS += (f"-DLINEAR_SCAN_STAGES={args.stages}",)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, t, d, with_h0 in SHAPES:
        x = torch.randn((b, t, d), device="cuda", generator=gen)
        a = torch.rand((b, t, d), device="cuda", generator=gen) * 0.5 + 0.5
        h0 = (torch.randn((b, d), device="cuda", generator=gen)
              if with_h0 else None)
        got, want = linear_scan(x, a, h0), linear_scan_plain(x, a, h0)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (b, t, d)
        ms = []
        for _ in range(REPEATS):
            for _ in range(WARMUP):
                linear_scan(x, a, h0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                linear_scan(x, a, h0)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end) / ITERS)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                linear_scan(x, a, h0)
            torch.cuda.synchronize()
        kernel_us = [e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and "linear_scan" in e.name]
        print(json.dumps({
            "root": str(root), "stages": args.stages, "shape": [b, t, d],
            "h0": with_h0, "ms": ms, "kernel_launches": len(kernel_us),
            "kernel_us": sum(kernel_us) / max(len(kernel_us), 1)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
