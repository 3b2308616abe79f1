#!/usr/bin/env python3
"""Time repro_torch's ``sig_hash`` and float32 ``flash_attention`` on one
NVIDIA GPU, at the shapes the main path gives them.

    python3 tools/time_kernels.py [ROOT] [--only sig_hash|flash]
                                  [--valid-rows N]

``ROOT`` is a checkout that holds ``src/repro_torch`` (by default the one
this script lies in), so the kernels of two trees can be timed on the
same card, each in its own process: run A, B, B, A and compare within
the call.  ``--only`` times one of the two kernels; ``--valid-rows``
sets how many of the parent's rows are valid (by default the sensor
workload's 1,110,000; 0 and 2097152 split its time into the hashing and
the sentinel stores).

The shapes:

- ``sig_hash`` in the fused sweep form at the sensor workload's
  Observation bucket: a (2^21, 8) int32 parent whose first 1,110,000
  rows are valid (the rest padding, as ``core/sweep.py`` pads a class)
  and 8 column masks (the drop-one stack), made from seed 0;
- float32 ``flash_attention`` at recurrentgemma-2b's flat prefill:
  q (8, 10, 2304, 256), k = v (8, 1, 2304, 256), causal, window 2048;
- bf16 ``flash_attention`` (the tensor-core kernel, as the serve path
  calls it) at the same shape and at qwen2-0.5b's flat prefill,
  q (8, 14, 2304, 64), k = v (8, 2, 2304, 64), causal.

Each is checked against its plain version first (``sig_hash`` bit for
bit, float32 flash within 1e-5, bf16 flash within each row's
``bf16_row_limit``), then timed two ways: CUDA events around
back-to-back calls of the wrapper (five repeats after warm-up calls),
and the kernel's own device time per launch from ``torch.profiler``.
Each flash line carries its bound, the kernel module's ``work`` at the
card's published peaks (``repro_torch.launch.mesh``), as
``chip_smoke.py`` reckons it (so ``ROOT`` must have both).  Prints the card's name and power limit,
then one JSON line per kernel.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPEATS = 5
SIG_SHAPE, SIG_VALID, SIG_CANDS = (1 << 21, 8), 1_110_000, 8
FLASH_Q, FLASH_KV, FLASH_WINDOW = (8, 10, 2304, 256), (8, 1, 2304, 256), 2048
# bf16 serve-path shapes: (q, kv, window)
BF16_CASES = (((8, 10, 2304, 256), (8, 1, 2304, 256), 2048),
              ((8, 14, 2304, 64), (8, 2, 2304, 64), None))
F32_TOL = 1e-5


def timed(fn, kernel: str, iters: int, warmup: int) -> dict:
    """CUDA-event ms per call over ``REPEATS`` runs of ``iters`` calls, and
    the device time per launch of the kernels named ``kernel*``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ms = []
    for _ in range(REPEATS):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    return {"ms": ms, "kernel_launches": len(us),
            "kernel_ms": sum(us) / max(len(us), 1) / 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--only", choices=("sig_hash", "flash"), default=None)
    ap.add_argument("--valid-rows", type=int, default=SIG_VALID)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import flash_attention, sig_hash
    from repro_torch.launch import mesh

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    if args.only != "flash":
        time_sig_hash(sig_hash, root, rng, dev, args.valid_rows)
    if args.only != "sig_hash":
        time_flash(flash_attention, mesh, root, rng, dev)
    return 0


def time_sig_hash(mod, root, rng, dev, n_valid):
    """``mod`` is the checkout's ``repro_torch.kernels.sig_hash``."""
    n, k = SIG_SHAPE
    parent = np.zeros((n, k), np.int32)
    parent[:n_valid, :5] = rng.integers(0, 1 << 24, (n_valid, 5))
    masks = np.ones((SIG_CANDS, k), np.int32)
    masks[:, 5:] = 0
    masks[np.arange(5), np.arange(5)] = 0              # drop-one rows
    parent, masks = (torch.from_numpy(x).to(dev) for x in (parent, masks))
    valid = torch.arange(n, device=dev) < n_valid
    kw = {"valid": valid, "col_masks": masks}
    assert torch.equal(mod.sig_hash(parent, **kw).view(torch.int32),
                       mod.sig_hash_plain(parent, **kw).view(torch.int32))
    rec = timed(lambda: mod.sig_hash(parent, **kw), "sig_hash", 50, 5)
    print(json.dumps({"root": str(root), "kernel": "sig_hash",
                      "shape": [n, k, SIG_CANDS], "valid_rows": n_valid,
                      **rec}), flush=True)


def bound_ms(mod, peaks, q, kv, dtype, window) -> float:
    """The least time of one flash call on the card: the larger of its
    bytes over HBM and its operations over the type's peak."""
    flops, nbytes = mod.work(q, kv, dtype, causal=True, window=window)
    peak = (peaks.PEAK_FLOPS_BF16 if dtype == torch.bfloat16
            else peaks.PEAK_FLOPS_F32)
    return max(nbytes / peaks.HBM_BW, flops / peak) * 1e3


def time_flash(mod, peaks, root, rng, dev):
    """``mod`` is the checkout's ``repro_torch.kernels.flash_attention``,
    ``peaks`` its ``repro_torch.launch.mesh``."""
    q, kk, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                 ).to(dev) for s in (FLASH_Q, FLASH_KV,
                                                     FLASH_KV))
    fkw = {"causal": True, "window": FLASH_WINDOW}
    err = float((mod.flash_attention(q, kk, v, **fkw) -
                 mod.flash_attention_plain(q, kk, v, **fkw)).abs().max())
    assert err <= F32_TOL, err
    rec = timed(lambda: mod.flash_attention(q, kk, v, **fkw), "flash_fwd",
                10, 2)
    print(json.dumps({"root": str(root), "kernel": "flash_attention float32",
                      "shape": [*FLASH_Q, FLASH_WINDOW], "max_abs_err": err,
                      "bound_ms": bound_ms(mod, peaks, FLASH_Q, FLASH_KV,
                                           torch.float32, FLASH_WINDOW),
                      **rec}), flush=True)
    for qs, kvs, window in BF16_CASES:
        q, kk, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dev, torch.bfloat16) for s in (qs, kvs, kvs))
        fkw = {"causal": True, "window": window}
        want = mod.flash_attention_plain(q, kk, v, **fkw)
        limit = mod.bf16_row_limit(q, kk, v, want, **fkw)
        delta = (mod.flash_attention(q, kk, v, **fkw).float() -
                 want.float()).abs()
        assert bool((delta <= limit).all()), float(delta.max())
        del want, limit
        rec = timed(lambda: mod.flash_attention(q, kk, v, **fkw),
                    "flash_sm90", 20, 3)
        print(json.dumps({"root": str(root),
                          "kernel": "flash_attention bf16",
                          "shape": [*qs, kvs[1], window],
                          "max_abs_err": float(delta.max()),
                          "bound_ms": bound_ms(mod, peaks, qs, kvs,
                                               torch.bfloat16, window),
                          **rec}),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
