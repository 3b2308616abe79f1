#!/usr/bin/env python3
"""Drive the repro_torch main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py                       # the full run, one card
    python3 chip_smoke.py --n-triples 200000    # a short rehearsal

Phases, each an assertion (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   from ``src/repro_torch/kernels/csrc`` (``kernels/build.py``, compiled
   afresh every run), each kernel's ``ptxas`` registers and spills (any
   spill, or a kernel with no ``ptxas`` line, fails the run);
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
4b. the compressed tier of phase 3's store (``store.compressed()``: at
   most half the plain substrate's bytes): ``Compactor("gfsp", "device")``
   and ``Compactor("efsp", "device")`` with ``run(cstore, stream=True)``,
   whose sweeps get each class's object matrix decoded one predicate
   partition at a time -- plans, per-class results, G' sha1 and digest
   identical to phase 3's device runs, both kernels launched, the decode
   peak (``DECODE_STATS``) at most 35% of the plain substrate, the device
   memory peak printed beside the plain plan's -- and phase 4's queries
   on its G' with identical answers;
4c. the gSpan-counted detectors on the 800-observation sensor graph:
   ``gspan``/host, ``efsp`` with ``min_support=2`` (the legacy path) and
   ``gfsp``/device, gspan's SP and edges equal to gfsp's on every class,
   their detect times and the gspan / gfsp ratio (the paper's baseline
   comparison), and each kernel against its plain version on the inputs
   of every shape launched there;
4d. mutations of phase 3's G' on three twins -- phase 3's gfsp/device
   and gfsp/host snapshots, and phase 4b's gfsp/device G' re-hosted on
   the compressed tier -- through ``CompactionPlanner``: one id-level
   ``apply_update`` of 9,999 triples (1,111 new entities of each class,
   half cloning existing object tuples, half novel), one ``apply_delete``
   of 1,000 triples (arms of support-2 molecules' members, so the payoff
   sweep decompacts) and 100 entities, one ``redetect`` of both classes:
   equal reports (the redetect's plans too), molecule tables and G' on
   the twins, the compressed twin migrated to the plain tier by the
   update (it leaves then: the delete and redetect run on the device
   and host twins), the digest equal to a ground truth computed without
   the code under test (the sorted, unique ``(original ∪ inserts) −
   deletes``), ``validate()``, both kernels launched by the device
   redetect and each held against its plain version on the inputs of
   every shape the phase launched;
4e. the durable online service at full size:
   ``OnlineCompactionService.durable`` over phase 3's device snapshot
   (device backend, a checkpoint every 4 applies) ingests 8 term-level
   batches of ``benchmarks/scale_cell.py``'s traffic (1,000 triples of a
   fresh sensor workload each, entities behind a per-batch prefix, every
   third batch deleting an earlier entity), a device ``QueryEngine``
   rebound after every step; a raise-mode fault at the sixth post-swap
   visit crashes it, ``recover`` rebuilds it from disk and the batch is
   resubmitted (the crashed service's checkpoint thread joined first,
   as the process's death would end it).  The queue must drain, the
   digest equal the ground truth, a redetect run on the device (both
   kernels launched), none fail or be retried, phase 4's 64 queries on
   the final snapshot equal ``eval_raw`` on the ground-truth store, and
   each kernel match its plain version on the inputs of every sweep and
   query shape the phase launched; per batch the apply and redetect times, swaps,
   and the checkpoint bytes, the recovery report, buffer evictions and
   the device memory peak are printed;
4f. the crash-point sweep: the reference's recovery matrix
   (``benchmarks/run.py``: 60 observations, 10 batches, sync checkpoints
   every 3 applies) on the device backend, one crash at each of the six
   fault sites at occurrence 0 and 1; the uninterrupted host and device
   runs must agree in tables, G', redetect count and descents, every
   cell crash, recover, drain and end digest-identical to them, no
   service see a failed or retried redetect, and each kernel match its
   plain version on the inputs of every shape the phase launched;
4g. the BGP engine and the graph-query server: (a) the reference's BGP
   matrix (``benchmarks/run.py`` ``bgp_matrix``: 4,000 observations with
   sensor stars, compacted by ``gfsp``/device, six workloads) through
   ``query_bgp`` in five strategy x backend cells (and the filter
   workload with post-hoc filters), every cell's binding-set digest,
   rows and largest intermediate equal to ``BENCH_fsp.json``'s, cold and
   warm ms printed, and ``calibration_report``'s fitted constants beside
   the committed ones; (b) ``GraphQueryService(backend="device")`` over
   phase 3's snapshot: one wave of 64 star requests (the four kinds of
   ``serve_graph_queries``) and 24 BGP requests (lookups on both
   classes, a ground arm with a variable arm, the Observation-Measurement
   chain with a ``<`` or ``>=`` value filter, a Measurement star with an
   ``==`` filter) run once per strategy (raw, factorized, auto): every
   response ``ok``, no raw fallback and no shed, identical binding sets
   across the waves, each equal to ``eval_raw`` / ``eval_bgp_reference``
   on the original store, and every star answer also equal to a plain
   scan of the original triples (``TripleScan``); the ``expand()`` seconds ``raw`` needs, the
   wave ms, the planner's per-star mix and the device memory peak are
   printed; (c) the ported ``serve_graph_queries``, ``serve_bgp_queries``
   and ``serve_online`` on the device backend at their defaults, then
   ``python -m repro_torch.launch.serve --online --durable DIR --chaos 0``
   twice: killed by SIGKILL, then recovered with its gates passed.
   ``sig_hash`` must launch in (a), (b) and (c), ``seg_count`` in (a)
   and ``serve_online``, and each must match its plain version on the
   inputs of every shape the phase launched it at;
4h. the sharded backend and the sharded graph, every mesh entry the one
   card (the exchange a permutation on it): (a) ``ami_bucketed_batch``
   at the gfsp sweep's (2^21, 8) x 8 on 4- and 8-way meshes, equal to
   the one-device sweep's counts, and on a 2^19-row slice at the
   default headroom and one that overflows, equal to the same call on
   a CPU mesh (the kernels' plain versions); (b) ``Compactor(...,
   "sharded")`` on a 4-way mesh, gfsp ``run`` and the efsp plan, plans,
   G' sha1 and digest equal to phase 3's device runs; (c)
   ``ShardedFactorizedGraph.partition`` into 4 shards, ``detect_all``
   on the device backend with the split classes' AMI by the exchange
   (equal to the host count), the digest equal to phase 3's, traffic
   and resident bytes per shard printed; (d) ``BENCH_fsp.json``'s eight
   ``shard_matrix`` cells (100k and 1M triples, 1/2/4/8 shards) on the
   card, digests, query digests, ``collective_ami``, ``traffic``,
   ``shard_weights`` and resident bytes equal to the record; (e) 4g(b)'s
   ``auto`` wave (stars factorized, BGPs planned) through
   ``ShardedQueryService`` over (c)'s shards: every response ``ok``, no
   fallback or shed, the binding sets of 4g(b)'s replicated
   ``GraphQueryService`` responses; (f) ``python -m repro_torch.launch.serve
   --sharded 4`` at its defaults.  Both kernels must launch in (a)-(d),
   and each must match its plain version on the inputs of every shape
   the phase launched it at;
5. each kernel against its plain version on the inputs of every shape
   phases 3-4 launched it at, then its launches on the main path, its
   time beside its plain version's, its bound and a library yardstick,
   on the widest gfsp sweep's inputs (``sig_hash``'s bound counts the
   work it must do: the valid rows' reads and hashes, and every
   signature written);
6. kernel parity: ``flash_attention`` and ``linear_scan`` against their
   plain torch versions on the card over random inputs (bf16 and
   float32, ragged T and S, T < S, GQA groups 1/2/4/6/8/10/16, D 64/128/256,
   causal or not, windows, fully masked rows; the scan at T = 1 with
   and without h0), within the tolerances below;
7. the LM serve path at full width: recurrentgemma-2b (26 layers, d 2560,
   vocab 256000, bf16, seeded random weights on the card) behind
   ``serving.Engine``, 8 requests of 2304 tokens (a shared 2048-token
   system prompt + 256 of their own), 16 new tokens each, under the
   ``flat`` and the ``auto`` policy, ``flat`` timed after an untimed
   pass and ``auto`` on its first (both record the kernels' inputs for
   phase 8); both LM kernels must launch (flash only as its bf16
   tensor-core kernel), as many times as the layers call them, every
   logit be finite, and the next-token logits of the two policies
   agree; then (7b) the two
   policies again in float32 on a reduced config (flash only as its
   float32 CUDA-core kernel), where they must agree to float32 rounding
   (tight enough to see a last prompt token decoded twice), and the
   float32 kernels against their plain versions on the inputs that path
   gave them;
7c. the same traffic (and its 7b) through the homogeneous stacks at
   their published width, depth cut to a third: qwen2-0.5b (8 of its 24
   layers of global GQA attention, d 896, 14/2 heads x 64, vocab
   151936: the bf16 flash kernel at head size 64, causal, no window,
   and no scan) and mamba2-780m (16 of its 48 SSD layers, d 1536, 48 heads
   x 64, state 128: ``linear_scan`` as SSD's inter-chunk recurrence at
   (8 x 48, 9, 128 x 64), and no flash).  mamba2 holds no KV bytes, so
   ``auto`` must plan no sharing and serve ``flat``'s tokens and logits;
7d. the same traffic (and its 7b) through the MoE stack
   moonshot-v1-16b-a3b at its published width (48 layers of attention,
   16 heads x 128, and a dropless MoE of 64 experts, top-6, ff 1408;
   51.6 GiB of bf16 weights): the bf16 flash kernel at head size 128,
   the expert-sorted GEMMs on the host-read group sizes in prefill and
   every expert batched in decode; the peak device memory printed for
   each policy;
7e. whisper-medium (24 + 24 layers, d 1024, 16 heads x 64, learned
   positions) and internvl2-2b (24 layers, 16/8 heads x 128) at full
   width through ``serve_step`` with seeded frontend embeddings (8 x
   1500 frames of 30 s of audio before a 224-token prompt; 8 x 256
   patches before phase 7's 2304 text tokens), 16 new tokens: flash
   launched as its bf16 kernel by the encoder (non-causal, S = 1500),
   every self-attention prefill and every cross-attention (T = 224 in
   prefill, T = 1 in each decode step), every logit finite, and a
   prefill of T - 1 tokens plus one decode step within 4 bf16 steps of
   a prefill of T; the same in float32 on the reduced configs within
   1e-5, flash as its CUDA-core kernel;
7f. every config of ``ARCHS`` at its published width, cut to 2 layers
   (2 encoder layers; recurrentgemma keeps its 3-layer pattern): a
   128-token prefill and one decode step at batch 1, every logit
   finite, flash launched at the config's head size (64, 128 or 256)
   by its attention layers, the scan by its recurrent ones -- the only
   run on the card of qwen3-32b, llama3-405b and dbrx-132b, and of GQA
   groups 4, 6, 8 and 16 on a served path;
8. both LM kernels against their plain versions on the inputs phases 7
   and 7c-7f launched them with (one per distinct shape; bf16 flash within
   each query row's limit, which a control -- the plain version with
   one in-band KV tile left out -- must break; the scan bit for bit),
   and their times, plain times, bounds and library yardsticks at every
   shape those phases recorded (the scan's decode step among them); the
   float32 CUDA-core flash kernel at the largest prefill shape beside
   them.  The largest shapes' numbers (recurrentgemma-2b's flat prefill)
   go into the record.

Phases 3-4 (for phase 5) and each of 4c-4h record the inputs of
``sig_hash`` and ``seg_count`` as they run (``KernelInputs``: a host
copy of the first call of each shape) and hold the kernels on them
afterwards, bit for bit; those launches come after the phase's counts
are read and are not counted.

Phases 7 and 7c-7e also trace one flat prefill and four decode steps
of each model with ``torch.profiler`` and print the device's busy and
idle share and the kernels that took most of its time.

The last two lines are the ``{"kernels": [...]}`` record -- five routes:
``sig_hash``, ``seg_count`` (their launches summed over phases 3-4h),
``flash_attention`` (bf16, tensor cores; launches of phases 7 and
7c-7f), ``flash_attention_f32`` (float32, CUDA cores; launches of the
7b runs and 7e's float32 checks, its time at the largest prefill shape)
and ``linear_scan`` (launches of phases 7, 7c and 7f) -- and the
``{"ok": true, "device": ...}`` line.
Without CUDA, or without the package beside this file, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# lane rate of one 64-lane/clk/SM integer pipe, half the float32 lanes of
# the 67 TFLOP/s FMA figure (2 flops per FMA).  Integer work goes to two
# such pipes at once: IMAD to the FMA pipe, shifts and logic
# (SHF/LOP3/IADD3) to the INT32 ALU pipe; the busier pipe sets the floor.
HBM_BYTES_PER_S = 3.35e12
INT32_PIPE_OPS_PER_S = 67e12 / 2 / 2
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

N_QUERIES = 64
SEED = 0

# kernel parity: ragged row counts and column counts (bucket rungs and not)
PARITY_N = (1, 1000, (1 << 21) + 3)
PARITY_K = (2, 3, 8, 32)

# phase 6/8 tolerances, absolute, per output dtype.  flash_attention in
# float32 (the CUDA-core kernel): both sides compute in float32 from the
# same inputs and differ in summation order only -- 1e-5.  In bf16 (the
# tensor-core kernel) the kernel also rounds each softmax weight p_k to
# bf16 before PV (l sums them unrounded): a relative change of at most
# 2**-9 per weight, which moves output j of a row by at most 2**-9 *
# sum_k p_k |v_kj| -- not 2**-9 of the output, since a row that averages
# 2000 unit-normal values has outputs near 0.04 and sums near 0.8.  Both
# sides then round to bf16, half a step each, one step at magnitude m
# being 2**(floor(log2 m) - 7).  So each query row has its own limit
# (``flash_attention.bf16_row_limit``): FLASH_BF16_STEPS steps at the
# row's largest |output| plus 2**-9 times its largest sum_k p_k |v_kj|.
# Phase 8 shows that the limit sees a wrong kernel: the plain version
# with one in-band 64-key tile left out of PV must break it.
# linear_scan: bit-exact (both take each step as one rounded multiply and
# one rounded add).
TOL = {"flash_attention_f32": {"float32": 1e-5},
       "linear_scan": {"float32": 0.0, "bfloat16": 0.0}}
FLASH_BF16_STEPS = 2
# phase 7: the flat and the auto policy reach the same next-token logits
# by different bf16 paths (one flash prefill over 2304 tokens, against a
# 2048-token molecule prefill plus 256 decode-extend steps).  The logits
# leave the tied head in bf16, where one step at magnitude m is
# 2**(floor(log2 m) - 7); the two paths may round the hidden state
# differently, so they may differ by this many steps at the largest
# logit's magnitude
LM_LOGIT_STEPS = 4
# phase 7b: the same two policies in float32 on the card must agree to
# float32 rounding (summation order of the GEMMs and of flash against
# decode attention), as the CPU tests hold them; decoding the last prompt
# token twice moves the logits by about 3e-4 at this scale
LM_F32_TOL = 1e-5

# phase 7 traffic, served by each of these at full width: the hybrid
# recurrentgemma-2b (phase 7), the dense qwen2-0.5b and the SSM
# mamba2-780m (phase 7c), the MoE moonshot-v1-16b-a3b (phase 7d)
LM_ARCHS = ("recurrentgemma-2b", "qwen2-0.5b", "mamba2-780m",
            "moonshot-v1-16b-a3b")
# phase 7c's stacks, depth cut to a third (24 -> 8, 48 -> 16 layers) to
# keep the script near 1100 s (the time budget's second cut, PERF.md §4)
LM_DEPTH = {"qwen2-0.5b": 8, "mamba2-780m": 16}
# phase 7e: the frontend stubs through serve_step at full width.  whisper
# decodes after a 224-token prompt (Whisper's prompt limit, half its
# 448-token context) over 30 s of audio (1500 frames); internvl2 reads
# 256 patches before phase 7's 2304 text tokens
STUB_ARCHS = ("whisper-medium", "internvl2-2b")
WHISPER_PROMPT = 224
# phase 7f: every config at its published width, depth cut to this many
# layers (a hybrid keeps one whole layer pattern, so it has attention),
# a prefill of this many tokens and one decode step at batch 1
SWEEP_LAYERS = 2
SWEEP_TOKENS = 128
LM_REQUESTS = 8
LM_SHARED = 2048
LM_OWN = 256
LM_NEW = 16
LM_CHUNK = 256


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


def kernel_name(mangled: str) -> str:
    """``name`` plus its template arguments (still mangled) from the
    Itanium symbol of a kernel inside a namespace: the last of the
    length-prefixed names after ``_ZN``."""
    i, name = mangled.index("_ZN") + 3, ""
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    m = re.match(r"I(\w*?E)E", mangled[i:])
    return name + (f"I{m.group(1)}" if m else "")


def bf16_steps(m: float, n: int) -> float:
    """``n`` bf16 rounding steps at magnitude ``m`` (0 at m = 0)."""
    return n * 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


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

# per kernel route (flash_attention: the bf16 tensor-core kernel;
# flash_attention_f32: the float32 CUDA-core one): largest difference from
# its plain version, the largest limit a case was held to, cases checked
ROUTES = ("sig_hash", "seg_count", "flash_attention", "flash_attention_f32",
          "linear_scan")
ERR = {name: 0.0 for name in ROUTES}
LIMIT = {name: 0.0 for name in ROUTES}
CASES = {name: 0 for name in ROUTES}


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

def _kernel_modules():
    from repro_torch.kernels import (flash_attention, linear_scan, seg_count,
                                     sig_hash)
    return {"sig_hash": sig_hash, "seg_count": seg_count,
            "flash_attention": flash_attention, "linear_scan": linear_scan}


def reset_launches() -> None:
    for mod in _kernel_modules().values():
        mod.launches = 0
    fa = _kernel_modules()["flash_attention"]
    fa.tensor_core_launches = fa.cuda_core_launches = 0


def flash_kernel_launches() -> dict[str, int]:
    """The two flash kernels' launch counts since the last reset."""
    fa = _kernel_modules()["flash_attention"]
    return {"tensor_core": fa.tensor_core_launches,
            "cuda_core": fa.cuda_core_launches}


def read_launches(names=("sig_hash", "seg_count")) -> dict[str, int]:
    mods = _kernel_modules()
    return {n: mods[n].launches for n in names}


# device memory allocated above the start of each plan (bytes), by
# (detector, backend, tier)
PLAN_DEVICE_PEAK: dict = {}


def device_peak_start() -> int:
    """Resets the device's peak-memory count; returns what is allocated
    now, the base that :func:`device_peak` subtracts."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def device_peak(start: int) -> int:
    import torch
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - start


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
        mem_start = device_peak_start()
        t0 = time.perf_counter()
        plan = comp.plan(store)              # detection (the sweeps)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        PLAN_DEVICE_PEAK[(det, be, "plain")] = device_peak(mem_start)
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
    """Phase 4; returns the queries and their answers."""
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
    return queries, got


# ---------------------------------------------------------------------------
# phase 4b: the compressed tier, streamed
# ---------------------------------------------------------------------------

# the limits of benchmarks/check_snapshot.py, which holds the JAX package
# to them: the compressed substrate at most half the plain one, and the
# streamed run's decoded partitions never over 35% of the plain substrate
MAX_COMPRESSED_FRAC = 0.5
MAX_DECODE_RESIDENT_FRAC = 0.35


def same_detections(got, want, what: str) -> None:
    """Per-class results of two reports: the plan rows and every star
    pattern (its entities and object tuple)."""
    import numpy as np
    assert plan_rows(got) == plan_rows(want), f"{what}: plans differ"
    for e, w in zip(got.plan, want.plan):
        assert len(e.detection.fsp) == len(w.detection.fsp), what
        for (m, o), (wm, wo) in zip(e.detection.fsp, w.detection.fsp):
            assert np.array_equal(m, wm) and np.array_equal(o, wo), \
                f"{what}: star patterns of class {e.class_id} differ"


def compressed_tier(store, runs, queries, answers, totals):
    """Phase 4b; returns its gfsp compactor."""
    import torch
    from repro_torch.api import Compactor
    from repro_torch.core import sweep
    from repro_torch.core.compress import DECODE_STATS
    from repro_torch.query import QueryEngine

    t0 = time.perf_counter()
    cstore = store.compressed()
    t_store = time.perf_counter() - t0
    t0 = time.perf_counter()
    cstore.index                       # the bit-packed CSR partitions
    t_index = time.perf_counter() - t0
    n = store.n_triples
    plain_b, comp_b = store.substrate_nbytes(), cstore.substrate_nbytes()
    log(f"compressed tier: store.compressed() {t_store:.2f} s (rows and "
        f"front-coded dictionary) + index {t_index:.2f} s; substrate "
        f"{plain_b} B plain ({plain_b / n:.2f} B/triple) -> {comp_b} B "
        f"compressed ({comp_b / n:.2f} B/triple), {comp_b / plain_b:.4f} "
        "of plain; without the dictionaries "
        f"{store.substrate_nbytes(include_dict=False) / n:.2f} -> "
        f"{cstore.substrate_nbytes(include_dict=False) / n:.2f} B/triple")
    assert comp_b <= MAX_COMPRESSED_FRAC * plain_b, \
        f"compressed substrate {comp_b} B over half of {plain_b} B"

    gd_comp, gd, _ = runs[("gfsp", "device")]
    g_sha, digest = sha1(gd.graph.spo), gd_comp.snapshot.digest()
    cfg = None
    for det in ("gfsp", "efsp"):
        comp = Compactor(det, "device")
        sweep.reset_trace_stats()            # DECODE_STATS too
        reset_launches()
        mem_start = device_peak_start()
        t0 = time.perf_counter()
        plan = comp.plan(cstore, stream=True)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        PLAN_DEVICE_PEAK[(det, "device", "compressed")] = \
            device_peak(mem_start)
        report = comp.execute(cstore, plan)
        secs = time.perf_counter() - t0
        launched = read_launches()
        decode = dict(DECODE_STATS)
        for name, k in launched.items():
            assert k > 0, f"{name} was not launched by {det}/device " \
                "on the compressed tier"
            totals[name] += k
        peaks = {t: PLAN_DEVICE_PEAK[(det, "device", t)]
                 for t in ("plain", "compressed")}
        log(f"compressed {det}/device run(stream=True): {secs:.2f} s (plan "
            f"{t_plan:.2f} s, execute {secs - t_plan:.2f} s), launches "
            f"{launched}, decode: {decode['partitions']} partitions, "
            f"{decode['values']} values, peak resident "
            f"{decode['peak_resident_bytes']} B = "
            f"{decode['peak_resident_bytes'] / plain_b:.4f} of the plain "
            f"substrate; device memory over the plan's start: "
            f"{peaks['compressed']} B streamed compressed, "
            f"{peaks['plain']} B plain (phase 3)")
        assert decode["peak_resident_bytes"] <= \
            MAX_DECODE_RESIDENT_FRAC * plain_b, \
            f"decode peak {decode['peak_resident_bytes']} B over " \
            f"{MAX_DECODE_RESIDENT_FRAC} of {plain_b} B"
        same_detections(report, runs[(det, "device")][1],
                        f"compressed {det}/device")
        assert sha1(report.graph.spo) == g_sha, f"{det}: G' differs"
        assert comp.snapshot.digest() == digest, f"{det}: digest differs"
        if det == "gfsp":
            cfg = comp
    log(f"compressed-tier checks: plans and star patterns equal to phase "
        f"3's device runs, G' sha1 {g_sha}, digest {digest} on both")

    eng = QueryEngine(cfg.fgraph)
    sweep.reset_trace_stats()
    reset_launches()
    t0 = time.perf_counter()
    got = eng.query_batch(queries, backend="device")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = read_launches()
    assert launched["sig_hash"] > 0, "query path did not launch sig_hash"
    for name, k in launched.items():
        totals[name] += k
    for q, b, want in zip(queries, got, answers):
        assert b.same_as(want), f"query {q} on the compressed run's G' differs"
    log(f"compressed-tier queries: {len(queries)} via query_batch(device) in "
        f"{secs:.2f} s, launches {launched}, every answer identical to "
        "phase 4's")
    return cfg


# ---------------------------------------------------------------------------
# phase 4c: the gSpan-counted detectors
# ---------------------------------------------------------------------------

GSPAN_OBSERVATIONS = 800
GSPAN_SEED = 42


def gspan_baseline(totals) -> None:
    """Phase 4c."""
    import torch
    from repro_torch.api import Compactor
    from repro_torch.core import sweep
    from repro_torch.data.synthetic import SensorGraphSpec, generate

    store = generate(SensorGraphSpec(n_observations=GSPAN_OBSERVATIONS,
                                     seed=GSPAN_SEED))
    classes = [int(c) for c in store.classes()
               if store.class_stats(int(c)).properties.shape[0] >= 2]
    results, secs = {}, {}
    for label, det, be, opts in (
            ("gspan/host", "gspan", "host", {}),
            ("efsp min_support=2/device", "efsp", "device",
             {"min_support": 2}),
            ("gfsp/device", "gfsp", "device", {})):
        comp = Compactor(det, be, detector_opts=opts)
        sweep.clear_compile_cache()      # every sweep shape shows as new
        reset_launches()
        t0 = time.perf_counter()
        results[label] = {cid: comp.detect(store, cid) for cid in classes}
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        launched = read_launches()
        if det == "gfsp":
            for name, k in launched.items():
                assert k > 0, f"{name} was not launched by gfsp/device"
                totals[name] += k
            shapes = sorted(s[1:] for s in sweep.TRACE_COUNTS
                            if s[0] == "sweep")
        log(f"gspan phase {label}: detect {secs[label]:.4f} s over "
            f"{len(classes)} classes, launches {launched}")
        for cid, r in results[label].items():
            log(f"  class {cid}: SP {r.props} edges {r.edges} ami {r.ami} "
                f"evaluations {r.evaluations} iterations {r.iterations}")
    for cid in classes:
        g, f = results["gspan/host"][cid], results["gfsp/device"][cid]
        assert (g.props, g.edges) == (f.props, f.edges), \
            f"class {cid}: gspan {g.props}/{g.edges} != " \
            f"gfsp {f.props}/{f.edges}"
    log(f"gspan baseline ({store.n_triples} triples, {GSPAN_OBSERVATIONS} "
        f"observations): gspan SP and edges equal gfsp/device on all "
        f"{len(classes)} classes; gspan / gfsp detect time "
        f"{secs['gspan/host'] / secs['gfsp/device']:.1f}x; gfsp sweep "
        f"shapes {shapes}")


# ---------------------------------------------------------------------------
# phases 4d-4f: mutations, the durable online service, the crash sweep
# ---------------------------------------------------------------------------

# phase 4d: new entities per class (1111 x (6 + 3) = 9,999 triples on the
# sensor schema), half cloning existing object tuples; deletes
MUT_ENTITIES = 1111
MUT_DELETE_TRIPLES = 1000
MUT_DELETE_ENTITIES = 100
# phase 4e: benchmarks/scale_cell.py's traffic, a checkpoint every 4
# applied batches, a raise-mode crash at the sixth post-swap visit.  The
# traffic's entities reuse existing molecules, so support drifts only by
# the deletes' exits (one per third batch): a support-drift threshold of
# 2 makes the second delete dirty its class, one redetect at full size
ONLINE_BATCHES = 8
ONLINE_BATCH_TRIPLES = 1000
ONLINE_KW = dict(checkpoint_every=4, support_drift_threshold=2)
ONLINE_CRASH = ("post_swap", 5)
# phase 4f: the reference's recovery matrix (benchmarks/run.py)
SWEEP_OBSERVATIONS = 60
SWEEP_BATCHES = 10
SWEEP_KW = dict(detector="gfsp", raw_residue_threshold=4,
                support_drift_threshold=3)


def semantic_digest(base, inserts, del_triples, del_entities) -> tuple:
    """The ground truth, independent of the code under test: the sorted,
    unique ``(base ∪ inserts) − deletes`` (a deleted entity takes every
    triple it is the subject or the object of), and the first 16 hex
    digits of its sha1 -- what ``GraphSnapshot.digest`` must give."""
    import numpy as np
    rows = np.concatenate([np.asarray(base, np.int32).reshape(-1, 3),
                           np.asarray(inserts, np.int32).reshape(-1, 3)])
    rows = rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]
    keep = np.ones(rows.shape[0], bool)
    keep[1:] = (rows[1:] != rows[:-1]).any(axis=1)
    rows = rows[keep]
    void = np.dtype((np.void, 12))
    gone = np.isin(np.ascontiguousarray(rows).view(void).ravel(),
                   np.ascontiguousarray(np.asarray(
                       del_triples, np.int32).reshape(-1, 3)).view(void)
                   .ravel())
    ents = np.asarray(del_entities, np.int64).reshape(-1)
    gone |= np.isin(rows[:, 0], ents) | np.isin(rows[:, 2], ents)
    rows = np.ascontiguousarray(rows[~gone])
    return rows, sha1(rows)[:16]


def mutation_inserts(store, n: int, rng) -> list:
    """Term triples of ``n`` new complete entities of each class: the
    first half clone an existing entity's object tuple (their molecules
    exist), the rest carry novel objects (fresh surrogates)."""
    term = store.dict.term
    out = []
    for cid in (int(c) for c in store.classes()):
        props = store.class_properties(cid)
        _, mat = store.object_matrix(cid, props)
        cterm, tterm = term(cid), term(store.TYPE)
        pterms = [term(int(p)) for p in props]
        rows = mat[rng.integers(0, mat.shape[0], n // 2)].tolist()
        for j in range(n):
            s = f"e:4d/{cterm}/{j}"
            out.append((s, tterm, cterm))
            if j < n // 2:
                out += [(s, p, term(o)) for p, o in zip(pterms, rows[j])]
            else:
                out += [(s, p, f"o:4d/{cterm}/{j}/{k}")
                        for k, p in enumerate(pterms)]
    return out


def mutation_deletes(fg, rng) -> tuple:
    """``MUT_DELETE_TRIPLES`` triples and ``MUT_DELETE_ENTITIES`` entities
    to delete, spread over the classes: an arm of one member of each of
    many support-2 molecules (each exit leaves its molecule below payoff,
    which ``_payoff_sweep`` decompacts), the moved type edge of a member
    of larger molecules, raw triples, and members of larger molecules."""
    import numpy as np
    store = fg.store
    trips, ents = [], []
    n_cls = len(fg.tables)
    n_arm = MUT_DELETE_TRIPLES // 2 // n_cls
    n_type = MUT_DELETE_TRIPLES // 10 // n_cls
    n_ent = MUT_DELETE_ENTITIES // n_cls
    for cid, t in sorted(fg.tables.items()):
        sup = fg.support(cid)
        two = np.flatnonzero(sup == 2)
        for r in rng.choice(two, min(two.shape[0], n_arm),
                            replace=False).tolist():
            m = int(fg.members(int(t.surrogates[r]))[0])
            j = int(rng.integers(0, t.k))
            trips.append((m, t.props[j], int(t.objects[r, j])))
        big = rng.choice(np.flatnonzero(sup > 2), n_type + n_ent,
                         replace=False).tolist()
        for i, r in enumerate(big):
            mem = fg.members(int(t.surrogates[r]))
            if i < n_type:
                trips.append((int(mem[0]), store.TYPE, cid))
            else:
                ents.append(int(mem[-1]))
    spo = store.spo
    raw = spo[(spo[:, 1] != store.INSTANCE_OF) & (spo[:, 1] != store.TYPE)
              & ~fg.is_surrogate(spo[:, 0])]
    for i in rng.choice(raw.shape[0], MUT_DELETE_TRIPLES - len(trips),
                        replace=False).tolist():
        trips.append(tuple(int(x) for x in raw[i]))
    return (np.asarray(trips, np.int32),
            np.unique(np.asarray(ents, np.int64)))


def report_counts(rep) -> dict:
    """A report's counts, as equal across backends and tiers: no wall
    times, no store, no epoch (the compressed twin's snapshot is one swap
    ahead) and no lowerings (the host backend launches none); a plan as
    each entry's class, star pattern and predicted and baseline edges."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(rep):
        if f.name.endswith("_ms") or f.name in ("graph", "epoch",
                                                "lowerings"):
            continue
        v = getattr(rep, f.name)
        if f.name == "stats":
            v = dataclasses.asdict(v)
        elif f.name == "plan":
            v = [(e.class_id, tuple(e.props), e.predicted_edges,
                  e.baseline_edges) for e in v]
        out[f.name] = v
    return out


def table_rows(fg) -> list:
    return [(c, t.props, sha1(t.surrogates), sha1(t.objects), t.next_ordinal)
            for c, t in sorted(fg.tables.items())]


def mutations(store, runs, cfg, totals) -> None:
    """Phase 4d."""
    import numpy as np
    import torch
    from repro_torch.core import sweep

    rng = np.random.default_rng(SEED + 4)
    comps = {"device": runs[("gfsp", "device")][0],
             "host": runs[("gfsp", "host")][0]}
    # phase 4b's compressed device run: its G' re-hosted on the compressed
    # tier, so the update migrates it to the plain tier
    t0 = time.perf_counter()
    snaps = {k: c.snapshot for k, c in comps.items()}
    planners = {k: c.planner for k, c in comps.items()}
    snaps["compressed"] = cfg.snapshot.next(cfg.fgraph.with_store(
        cfg.graph.compressed(compact_dict=False)))
    planners["compressed"] = cfg.planner
    log(f"mutations: compressed G' ({snaps['compressed'].n_triples} "
        f"triples) in {time.perf_counter() - t0:.2f} s")
    assert snaps["compressed"].store.is_compressed

    def step(what, fn, twins=("device", "host")):
        reps, secs, launched, shapes = {}, {}, {}, None
        for k in twins:
            if k == "device":
                sweep.clear_compile_cache()  # every sweep shape shows as new
            reset_launches()
            t0 = time.perf_counter()
            snaps[k], reps[k] = fn(planners[k], snaps[k])
            torch.cuda.synchronize()
            secs[k] = time.perf_counter() - t0
            launched[k] = read_launches()
            if k == "device":
                shapes = sorted(s[1:] for s in sweep.TRACE_COUNTS
                                if s[0] == "sweep")
        counts = {k: report_counts(r) for k, r in reps.items()}
        assert all(c == counts["device"] for c in counts.values()), \
            f"{what}: reports differ {counts}"
        rows = {k: table_rows(snaps[k].fgraph) for k in twins}
        g = {k: sha1(snaps[k].store.spo) for k in twins}
        assert all(r == rows["device"] for r in rows.values()), \
            f"{what}: molecule tables differ"
        assert len(set(g.values())) == 1, f"{what}: G' differs {g}"
        log(f"mutations {what}: " + ", ".join(
            f"{k} {secs[k]:.2f} s" for k in secs) + f"; G' sha1 "
            f"{g['device']}, {snaps['device'].n_triples} triples, epoch "
            f"{snaps['device'].epoch}; {counts['device']}")
        return reps, launched, shapes

    d = store.dict
    ins = mutation_inserts(store, MUT_ENTITIES, rng)
    flat = [x for t in ins for x in t]
    rows = d.ids(flat).reshape(-1, 3)
    cdict = snaps["compressed"].store.dict
    assert cdict is not d
    assert np.array_equal(cdict.ids(flat).reshape(-1, 3), rows), \
        "the two dictionaries minted different ids"
    step("update", lambda p, s: p.apply_update(s, rows),
         ("device", "host", "compressed"))
    # migrated: from here on the compressed twin would run the plain
    # tier's code, as the other two do
    assert not snaps["compressed"].store.is_compressed
    del snaps["compressed"], planners["compressed"]

    del_trips, del_ents = mutation_deletes(snaps["device"].fgraph, rng)
    reps, _, _ = step("delete", lambda p, s: p.apply_delete(
        s, triples=del_trips, entities=del_ents))
    st = reps["device"].stats
    assert st.n_exits > 0 and st.n_decompacted > 0, st

    cids = [int(c) for c in store.classes()]
    reps, launched, shapes = step("redetect",
                                  lambda p, s: p.redetect(s, cids))
    red = reps["device"]
    assert red.descents > 0 and tuple(red.considered) == tuple(sorted(cids))
    for name, n in launched["device"].items():
        assert n > 0, f"{name} was not launched by the device redetect"
        totals[name] += n
    log(f"mutations redetect launches: {launched}; sweep shapes {shapes}")

    # the G' and their tables are equal (asserted per step), so their
    # expansions are: one digest stands for all
    gt_rows, gt = semantic_digest(store.spo, rows, del_trips, del_ents)
    digest = snaps["device"].digest()
    assert digest == gt, f"digest {digest} != ground truth {gt}"
    snaps["device"].fgraph.validate()
    log(f"mutations checks: reports (redetect plans included), tables and "
        f"G' equal on device and host (and compressed through the update); "
        f"digest {gt} == ground truth "
        f"({gt_rows.shape[0]} triples); validate ok")


def online_batches(store, n: int) -> list:
    """``benchmarks/scale_cell.py``'s traffic: per batch the first
    ``ONLINE_BATCH_TRIPLES`` triples of a fresh 2,000-triple sensor
    workload, entity terms (subjects, and objects that are subjects)
    behind a per-batch prefix; every third batch also deletes an entity
    inserted two batches before."""
    from repro_torch.data.synthetic import WorkloadSpec, generate_workload
    out = []
    for b in range(n):
        batch = generate_workload(WorkloadSpec(
            shape="sensor", n_triples=2_000, seed=SEED + 101 + b))
        subs = set(batch.spo[:, 0].tolist())
        t = batch.dict.term
        trips = [(f"b{b}/{t(s)}", t(p), f"b{b}/{t(o)}" if o in subs
                  else t(o))
                 for s, p, o in batch.spo[:ONLINE_BATCH_TRIPLES].tolist()]
        dels = [trips[0][0].replace(f"b{b}/", f"b{b - 2}/", 1)] \
            if b % 3 == 2 else None
        out.append((trips, dels))
    return out


def assert_no_failures(svc, what: str) -> None:
    """A redetect that failed (and was skipped) or was retried leaves the
    digest as it was: the service's channels must show none."""
    m = svc.metrics_summary()
    for ch in ("redetect.failures", "fault.retries"):
        n = m[ch]["count"] if ch in m else 0
        assert n == 0, f"{what}: {ch} count {n}"


def process_death(svc) -> None:
    """What the death of ``svc``'s process would end: its in-flight
    checkpoint thread (its error, the crash's, is dropped)."""
    try:
        svc._join_checkpoint()
    except Exception:
        pass


def durable_online(store, snap, backend, queries, totals) -> None:
    """Phase 4e."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import sweep
    from repro_torch.dist.fault import FaultPlan, InjectedFault
    from repro_torch.online import OnlineCompactionService, recover
    from repro_torch.query import QueryEngine, eval_raw
    from repro_torch.core.triples import TripleStore

    seq = online_batches(store, ONLINE_BATCHES)
    kw = dict(ONLINE_KW, backend=backend)
    root = tempfile.mkdtemp(prefix="chip_smoke_online_")
    mem_start = device_peak_start()
    reset_launches()
    sweep.clear_compile_cache()          # every shape shows as new
    try:
        t0 = time.perf_counter()
        svc = OnlineCompactionService.durable(
            root, snap, fault_plan=FaultPlan(ONLINE_CRASH[0],
                                             occurrence=ONLINE_CRASH[1]),
            **kw)
        log(f"online: durable service over {snap.n_triples} triples, "
            f"initial checkpoint in {time.perf_counter() - t0:.2f} s")
        eng = QueryEngine(svc.fgraph, epoch=svc.snapshot.epoch,
                          metrics=svc.metrics)
        probe = queries[:8]
        fell, rec = False, None
        for b, (ins, dels) in enumerate(seq):
            for _ in range(2):
                try:
                    svc.submit(inserts=ins, delete_entities=dels)
                    while True:
                        rep = svc.step()
                        if rep is None:
                            break
                        eng.rebind(svc.fgraph, svc.snapshot.epoch)
                        eng.query_batch(probe, backend="device")
                        red = rep.redetect
                        log(f"online batch {b} (seq {rep.seq}): apply "
                            f"{rep.latency_ms:.1f} ms, epoch "
                            f"{rep.epoch_before} -> {rep.epoch_after}, "
                            + (f"redetect {red.exec_time_ms:.1f} ms of "
                               f"classes {list(red.considered)} "
                               f"({red.descents} descents, "
                               f"{'rejected' if red.rejected else 'kept'}, "
                               f"{red.edges_before} -> {red.edges_after} "
                               "triples)" if red is not None
                               else "no redetect")
                            + f", swaps {svc.swap_count}")
                    break
                except InjectedFault as e:
                    assert not fell, "crashed twice"
                    fell = True
                    log(f"online batch {b}: {e}; recovering")
                    process_death(svc)
                    assert_no_failures(svc, "online, before the crash")
                    svc = recover(root, **kw)
                    rec = svc.last_recovery
                    log(f"online recovery: {rec.as_dict()}")
                    eng.rebind(svc.fgraph, svc.snapshot.epoch)
            else:
                raise AssertionError(f"batch {b} kept crashing")
        svc.checkpoint(wait=True)
        svc.close()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = read_launches()
        peak = device_peak(mem_start)
        m = svc.metrics_summary()
        assert fell and rec is not None, "the armed fault never fired"
        assert svc.queue.depth == 0, "queue not drained"
        assert m["redetect.ms"]["count"] > 0, "no redetect ran"
        assert_no_failures(svc, "online")
        for name, n in launched.items():
            assert n > 0, f"{name} was not launched by the online service"
            totals[name] += n
        d = svc.snapshot.store.dict
        ins_ids = np.asarray([[d.lookup(x) for x in t] for ins, _ in seq
                              for t in ins], np.int64).astype(np.int32)
        del_ids = [d.lookup(e) for _, dels in seq for e in (dels or [])]
        assert None not in del_ids
        gt_rows, gt = semantic_digest(store.spo, ins_ids,
                                      np.empty((0, 3), np.int32), del_ids)
        digest = svc.snapshot.digest()
        assert digest == gt, f"online digest {digest} != ground truth {gt}"
        gt_store = TripleStore.from_ids(d, gt_rows, presorted=True)
        got = eng.query_batch(queries, backend="device")
        for q, g in zip(queries, got):
            assert g.same_as(eval_raw(gt_store, q)), \
                f"query {q} on the online snapshot differs from eval_raw"
        shapes = sorted(sweep.TRACE_COUNTS)
        log(f"online: {len(seq)} batches in {secs:.2f} s; checkpoint "
            f"{m['checkpoint.bytes']['last']:.0f} B (count "
            f"{m['checkpoint.count']['count']}); redetects "
            f"{m['redetect.ms']['count']} ({m['redetect.ms']['total']:.1f} "
            f"ms); apply ms mean {m['ingest.batch_ms']['mean']:.1f}; buffer "
            f"evictions {eng.buffer_evictions}; launches {launched}; device "
            f"memory peak {peak} B over the phase's start; digest {digest} "
            f"== ground truth; {len(queries)} queries equal eval_raw on the "
            f"ground-truth store; no redetect failed or was retried; bucket "
            f"shapes {shapes}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def crash_sweep(backend, totals) -> None:
    """Phase 4f."""
    import tempfile
    import numpy as np
    from repro_torch.core import sweep
    from repro_torch.data.synthetic import SensorGraphSpec, generate
    from repro_torch.dist.fault import SITES, FaultPlan, InjectedFault
    from repro_torch.online import OnlineCompactionService, recover

    def build_store():
        return generate(SensorGraphSpec(n_observations=SWEEP_OBSERVATIONS,
                                        seed=5))

    def batches(store, n):
        term = store.dict.term
        cid = int(store.classes()[0])
        props = np.asarray(store.class_properties(cid))
        cterm, tterm = term(cid), term(store.TYPE)
        pterms = [term(int(p)) for p in props]
        out = []
        for i in range(n):
            ins = []
            for j in range(3):
                s = f"e:n/b{i}/{j}"
                ins.append((s, tterm, cterm))
                ins += [(s, p, f"o:novel/b{i}/{j}/{k}")
                        for k, p in enumerate(pterms)]
            out.append((ins, [f"e:n/b{i - 2}/0"] if i % 3 == 2 else None))
        return out

    kw = dict(SWEEP_KW, backend=backend, retry_sleep=lambda _: None)
    seq = batches(build_store(), SWEEP_BATCHES)
    sweep.clear_compile_cache()          # every shape shows as new
    want, refs = {}, {}
    for label, be in (("host", "host"), ("device", backend)):
        ref = OnlineCompactionService(build_store(), **dict(kw, backend=be))
        for ins, dels in seq:
            ref.submit(inserts=ins, delete_entities=dels)
            ref.drain()
        assert_no_failures(ref, f"crash sweep, uninterrupted {label} run")
        want[label] = ref.snapshot.digest()
        m = ref.metrics_summary()
        refs[label] = (table_rows(ref.snapshot.fgraph),
                       sha1(ref.snapshot.store.spo),
                       m.get("redetect.ms", {"count": 0})["count"],
                       m.get("redetect.descents", {"total": 0})["total"])
    assert want["host"] == want["device"], want
    assert refs["host"] == refs["device"], \
        "crash sweep: the uninterrupted host and device runs differ in " \
        "tables, G', redetect count or descents"
    assert refs["device"][2] > 0, "crash sweep: no redetect ran"
    end_store = ref.snapshot.fgraph.expand()
    reset_launches()
    cells = 0
    for site in SITES:
        for occ in (0, 1):
            root = tempfile.mkdtemp(prefix="chip_smoke_crash_")
            try:
                svc = OnlineCompactionService.durable(
                    root, build_store(),
                    fault_plan=FaultPlan(site, occurrence=occ),
                    checkpoint_every=3, checkpoint_async=False, **kw)
                crashed = False
                for ins, dels in seq:
                    for _ in range(2):
                        try:
                            svc.submit(inserts=ins, delete_entities=dels)
                            svc.drain()
                            break
                        except InjectedFault:
                            crashed = True
                            assert_no_failures(svc, f"{site} occ={occ}")
                            svc = recover(root, **kw)
                    else:
                        raise AssertionError(f"{site} kept crashing")
                svc.close()
            finally:
                shutil.rmtree(root, ignore_errors=True)
            rec = svc.last_recovery
            ok = svc.snapshot.digest() == want["device"]
            log(f"crash sweep {site:16s} occ={occ}: crashed={crashed} "
                f"parity={ok} drained={svc.queue.depth == 0} checkpoint "
                f"{rec.checkpoint_bytes} B, replay {rec.replay_ms:.1f} ms, "
                f"batches {rec.batches_pending}, mints {rec.mints_replayed}")
            assert crashed and ok and svc.queue.depth == 0, (site, occ)
            assert_no_failures(svc, f"{site} occ={occ}, recovered")
            cells += 1
    launched = read_launches()
    for name, n in launched.items():
        assert n > 0, f"{name} was not launched by the crash sweep"
        totals[name] += n
    sweeps = sorted(s[1:] for s in sweep.TRACE_COUNTS if s[0] == "sweep")
    log(f"crash sweep: {cells} cells crashed, recovered and ended "
        f"digest-identical ({want['device']}) to the uninterrupted run; "
        f"uninterrupted host and device runs equal in tables, G' and "
        f"{refs['device'][2]} redetects; no redetect failed or was retried; "
        f"launches {launched}; sweep shapes {sweeps}")


# ---------------------------------------------------------------------------
# phase 4g: the BGP engine and the graph-query server
# ---------------------------------------------------------------------------

# 4g(a): the graph of the reference's BGP matrix (benchmarks/run.py
# bgp_matrix, fast), whose binding-set digests BENCH_fsp.json records
BGP_MATRIX_OBSERVATIONS = 4_000
BGP_MATRIX_SEED = 42
BGP_WORKLOADS = ("lookup", "var_arm", "filter", "2star", "3star", "mixed")
# (label, strategy, backend) of each cell, the labels BENCH_fsp.json uses;
# the filter workload also runs with its filters applied after the joins
BGP_CELLS = (("planner", "auto", "host"), ("raw", "raw", "host"),
             ("factorized", "factorized", "host"),
             ("factorized", "factorized", "device"),
             ("planner", "auto", "device"))
# 4g(b): one wave of requests over phase 3's snapshot, run once per
# strategy; the BGP requests cycle through these shapes
GRAPH_STAR_REQUESTS = 64
GRAPH_BGP_REQUESTS = 24
GRAPH_BGP_SHAPES = ("obs_lookup", "meas_lookup", "ground_var", "chain_lt",
                    "meas_eq", "chain_ge")
# 4g(c): the entry points at their defaults, and the kill-and-restart pair
ENTRY_STAR_REQUESTS = 64
ENTRY_BGP_REQUESTS = 24
ENTRY_ONLINE_BATCHES = 20
CHAOS_SEED = 0


def bgp_workloads(fg, d) -> dict:
    """The reference's BGP matrix workloads (``benchmarks/run.py``
    ``bgp_matrix``), built the same way on ``fg``: molecule ``lookup``s,
    ``var_arm`` scans, the off-SP ``residual`` probes (calibration only),
    ``2star`` joins, ``3star`` chains, the chains with pushed-down value
    ``filter``s, and the ``mixed`` bag."""
    from repro_torch.data.synthetic import (MEASUREMENT, OBSERVATION,
                                            P_MODEL, P_PROCEDURE, P_RESULT,
                                            P_VALUE, SENSOR)
    from repro_torch.query import BGPQuery, Filter, StarPattern

    obs, meas, sen = (d.lookup(t) for t in (OBSERVATION, MEASUREMENT,
                                            SENSOR))
    p_proc, p_model, p_res, p_val = (
        d.lookup(t) for t in (P_PROCEDURE, P_MODEL, P_RESULT, P_VALUE))
    tables = sorted(fg.tables.items())
    lookups = [
        BGPQuery(stars=(StarPattern(
            "?s", tuple((int(p), int(o)) for p, o in zip(t.props, row)),
            class_id=cid),))
        for cid, t in tables for row in t.objects[:48]]
    var_arm = [
        BGPQuery(stars=(StarPattern(
            "?s", ((int(t.props[0]), int(row[0])),
                   (int(t.props[-1]), "?v")), class_id=cid),))
        for cid, t in tables for row in t.objects[:16]]
    residual = [BGPQuery(stars=(StarPattern(
        f"?o{i}", ((p_res, f"?m{i}"),), class_id=obs),))
        for i in range(3)]
    joins2 = [
        BGPQuery(stars=(
            StarPattern("?o", ((p_proc, "?s"),), class_id=obs),
            StarPattern("?s", ((p_model, d.lookup(f"model/{m}")),),
                        class_id=sen)))
        for m in range(3)]
    chains3 = [
        BGPQuery(stars=(
            StarPattern("?o", ((p_proc, "?s"), (p_res, "?m")),
                        class_id=obs),
            StarPattern("?s", ((p_model, d.lookup(f"model/{m}")),),
                        class_id=sen),
            StarPattern("?m", ((p_val, "?v"),), class_id=meas)))
        for m in range(3)]
    filtered = [
        BGPQuery(stars=q.stars,
                 filters=(Filter("?v", op, d.lookup(f"val/{k}")),))
        for q in chains3 for op in ("<", ">=") for k in (2, 6)]
    mixed = (lookups[:24] + var_arm[:8] + residual + joins2 * 2
             + filtered[:2])
    return {"lookup": lookups, "var_arm": var_arm, "filter": filtered,
            "2star": joins2, "3star": chains3, "mixed": mixed,
            "residual": residual}


def bgp_digest(results) -> str:
    """The reference's binding-set digest of a workload's answers: sha1
    over each answer's ``canonical()`` bytes, in query order."""
    h = hashlib.sha1()
    for b in results:
        h.update(b.canonical().tobytes())
    return h.hexdigest()[:16]


class KernelInputs:
    """Records what ``sig_hash`` and ``seg_count`` are launched on while
    it is entered: it wraps ``ops.row_signature`` and
    ``ops.seg_boundaries`` (what every sweep and molecule match calls)
    and keeps a host copy of the inputs of the first call of each
    distinct shape (on the host, so a phase's device memory peak stays
    its own); the wrapped call runs unchanged and counts its launch as
    before.  :meth:`check` then holds each kernel against its plain
    version on every recorded input."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.orig = {"row_signature": ops.row_signature,
                     "seg_boundaries": ops.seg_boundaries}
        self.sig: dict = {}
        self.seg: dict = {}

    def _row_signature(self, mat, valid=None, col_masks=None):
        key = tuple(None if t is None else tuple(t.shape)
                    for t in (mat, valid, col_masks))
        if key not in self.sig:
            self.sig[key] = (mat.to("cpu", copy=True), {
                k: t.to("cpu", copy=True) for k, t in (
                    ("valid", valid), ("col_masks", col_masks))
                if t is not None})
        return self.orig["row_signature"](mat, valid=valid,
                                          col_masks=col_masks)

    def _seg_boundaries(self, sig_sorted):
        key = tuple(sig_sorted.shape)
        if key not in self.seg:
            self.seg[key] = sig_sorted.to("cpu", copy=True)
        return self.orig["seg_boundaries"](sig_sorted)

    def __enter__(self):
        self.ops.row_signature = self._row_signature
        self.ops.seg_boundaries = self._seg_boundaries
        return self

    def __exit__(self, *exc):
        self.ops.row_signature = self.orig["row_signature"]
        self.ops.seg_boundaries = self.orig["seg_boundaries"]

    @staticmethod
    def _on(dev, mat, kw):
        return mat.to(dev), {k: t.to(dev) for k, t in kw.items()}

    def check(self, dev) -> str:
        """Each kernel against its plain version on every recorded input
        (after the phase's counts were read); returns the shapes."""
        import torch
        from repro_torch.kernels.seg_count import (seg_boundaries,
                                                   seg_boundaries_plain)
        assert self.sig, "no sig_hash input was recorded"
        for key, (mat, kw) in sorted(self.sig.items(), key=str):
            parity_case(*self._on(dev, mat, kw), f"sig_hash input {key}",
                        seg=False)
        for key, srt in sorted(self.seg.items()):
            srt = srt.to(dev)
            (b, c), (pb, pc) = seg_boundaries(srt), seg_boundaries_plain(srt)
            torch.cuda.synchronize()
            for got, want, part in ((b, pb, "bounds"), (c, pc, "counts")):
                e = max_abs_diff(got, want)
                assert e == 0, \
                    f"seg_count disagrees with its plain version: {key} {part}"
                ERR["seg_count"] = max(ERR["seg_count"], e)
                CASES["seg_count"] += 1
        return (f"sig_hash at {sorted(self.sig, key=str)}, seg_count at "
                f"{sorted(self.seg)}")

    def widest_sweep(self, dev):
        """The recorded inputs of the widest gfsp sweep -- a parent with
        its drop-one stack, as many masks as columns -- on ``dev``."""
        sweeps = [(mat, kw) for mat, kw in self.sig.values()
                  if mat.dim() == 2 and "col_masks" in kw
                  and kw["col_masks"].shape[0] == mat.shape[1]]
        assert sweeps, "no gfsp sweep on the path"
        return self._on(dev, *max(sweeps, key=lambda r: r[0].numel()))


def with_parity(what: str, dev, fn, *args):
    """Runs the phase ``fn(*args)`` with the kernels' inputs recorded,
    then holds each kernel against its plain version on them."""
    with KernelInputs() as rec:
        out = fn(*args)
    log(f"{what} parity: {rec.check(dev)}, all bit-exact")
    return out


def add_launches(totals, what: str, need=("sig_hash",)) -> dict:
    """Reads and resets the launch counts, adds them to ``totals``, and
    fails if a kernel of ``need`` was not launched."""
    launched = read_launches()
    for name, n in launched.items():
        totals[name] += n
    for name in need:
        assert launched[name] > 0, f"{what} did not launch {name}"
    reset_launches()
    return launched


def bgp_matrix(totals) -> None:
    """Phase 4g (a): the reference's BGP matrix on the port, each cell's
    digest against ``BENCH_fsp.json``."""
    import torch
    from repro_torch.api import Compactor
    from repro_torch.data.synthetic import SensorGraphSpec, generate
    from repro_torch.query import QueryEngine
    from repro_torch.query.bgp import calibration_report

    bench = json.loads((ROOT / "BENCH_fsp.json").read_text())["bgp"]
    store = generate(SensorGraphSpec(
        n_observations=BGP_MATRIX_OBSERVATIONS, seed=BGP_MATRIX_SEED,
        include_sensor_metadata=True))
    assert store.n_triples == bench["graph"]["n_triples"], store.n_triples
    reset_launches()
    comp = Compactor("gfsp", "device")
    comp.run(store)
    add_launches(totals, "the bgp matrix's compaction",
                 ("sig_hash", "seg_count"))
    eng = QueryEngine(comp.fgraph)
    eng.raw_store             # the raw baseline, built outside the timers
    wl = bgp_workloads(comp.fgraph, store.dict)

    def run_once(queries, strategy, backend, posthoc):
        out, mi = [], 0
        for q in queries:
            b, st = eng.query_bgp(q, strategy=strategy, backend=backend,
                                  posthoc_filters=posthoc,
                                  return_stats=True)
            out.append(b)
            mi = max(mi, st["max_intermediate"])
        torch.cuda.synchronize()
        return out, mi

    for name in BGP_WORKLOADS:
        want = {(c["strategy"], c["backend"]): c
                for c in bench["workloads"][name]}
        digests = {c["digest"] for c in want.values()}
        assert len(digests) == 1, (name, digests)
        cells = BGP_CELLS + ((("posthoc", "factorized", "host"),)
                             if name == "filter" else ())
        for label, strategy, backend in cells:
            posthoc = label == "posthoc"
            t0 = time.perf_counter()
            res, mi = run_once(wl[name], strategy, backend, posthoc)
            cold = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            res, mi = run_once(wl[name], strategy, backend, posthoc)
            warm = (time.perf_counter() - t0) * 1e3
            digest = bgp_digest(res)
            n_rows = sum(b.n_rows for b in res)
            ref = want.get((label, backend), want[(label, "host")])
            log(f"bgp matrix {name:8s} {label}x{backend}: cold {cold:.3f} "
                f"ms, warm {warm:.3f} ms, rows {n_rows}, max intermediate "
                f"{mi}, digest {digest}")
            assert digest in digests, \
                f"bgp {name} {label}x{backend}: digest {digest} != {digests}"
            assert (n_rows, mi) == (ref["n_rows"], ref["max_intermediate"]), \
                (name, label, backend, n_rows, mi)
    launched = add_launches(totals, "the bgp matrix's device cells")
    cal = calibration_report(eng, {k: wl[k] for k in (
        "lookup", "var_arm", "filter", "2star", "3star", "residual")})
    log(f"bgp matrix: {len(BGP_WORKLOADS)} workloads x {len(BGP_CELLS)} "
        f"cells (+ posthoc filter), every digest equal to BENCH_fsp.json's; "
        f"query launches {launched}; calibration over "
        f"{cal['n_samples']} samples, rel_l1 {cal['rel_l1_error']}: fitted "
        f"{cal['fitted']} (committed {cal['committed']}, kept)")


def graph_star_requests(fg, d, n: int, rng) -> list:
    """``serve_graph_queries``'s four kinds at the term level: a variable
    scan over one arm (the first request of each class: it answers every
    member, 1.11M rows a class at 10M), then a full molecule lookup, a
    ground arm with a variable arm and a miss (an object of another
    column) in turn."""
    from repro_torch.serving import GraphQueryRequest
    term = d.term
    classes = sorted(fg.tables.items())
    out = []
    for i in range(n):
        cid, t = classes[i % len(classes)]
        row = t.objects[int(rng.integers(0, t.n_molecules))]
        kind = 3 if i < len(classes) else (i // len(classes)) % 3
        if kind == 0:
            arms = tuple((term(p), term(int(o)))
                         for p, o in zip(t.props, row))
        elif kind == 1:
            arms = ((term(t.props[0]), term(int(row[0]))),
                    (term(t.props[-1]), None))
        elif kind == 2:
            arms = ((term(t.props[0]), term(int(row[-1]))),)
        else:
            arms = ((term(t.props[0]), None),)
        out.append(GraphQueryRequest(rid=i, arms=arms, class_term=term(cid)))
    return out


def graph_bgp_requests(fg, d, n: int, rid0: int, rng) -> list:
    """BGP requests on the 10M sensor schema, cycling through
    ``GRAPH_BGP_SHAPES``: ground-SP lookups on both classes, a ground arm
    with a variable arm, the Observation-Measurement chain over
    ``observationResult`` with a ``<`` or ``>=`` value filter (the schema
    has no sensor stars to join), and a Measurement star with an ``==``
    filter.  The oracle's hash join walks every Measurement for each
    distinct chain or filter query (seconds apiece at 10M), so those
    repeat: one sensor for the chains, one value for the filter."""
    from repro_torch.data.synthetic import (MEASUREMENT, OBSERVATION,
                                            P_PROCEDURE, P_RESULT, P_TIME,
                                            P_VALUE)
    from repro_torch.serving import BGPQueryRequest
    term = d.term
    tabs = {OBSERVATION: fg.tables[d.lookup(OBSERVATION)],
            MEASUREMENT: fg.tables[d.lookup(MEASUREMENT)]}
    obs = tabs[OBSERVATION]
    proc = obs.objects[rng.integers(0, obs.n_molecules, 2),
                       obs.col_of(d.lookup(P_PROCEDURE))]
    sensors = [term(int(s)) for s in proc]
    out = []
    for i in range(n):
        shape = GRAPH_BGP_SHAPES[i % len(GRAPH_BGP_SHAPES)]
        sensor = sensors[(i // len(GRAPH_BGP_SHAPES)) % 2]
        filters = ()
        if shape in ("obs_lookup", "meas_lookup"):
            cls = OBSERVATION if shape == "obs_lookup" else MEASUREMENT
            t = tabs[cls]
            row = t.objects[int(rng.integers(0, t.n_molecules))]
            stars = (("?s", tuple((term(p), term(int(o)))
                                  for p, o in zip(t.props, row)), cls),)
        elif shape == "ground_var":
            stars = (("?o", ((P_PROCEDURE, sensor), (P_TIME, "?t")),
                      OBSERVATION),)
        elif shape in ("chain_lt", "chain_ge"):
            stars = (("?o", ((P_PROCEDURE, sensors[0]), (P_RESULT, "?m")),
                      OBSERVATION),
                     ("?m", ((P_VALUE, "?v"),), MEASUREMENT))
            filters = (("?v", "<", "val/6") if shape == "chain_lt"
                       else ("?v", ">=", "val/2"),)
        else:
            filters = (("?v", "==", "val/3"),)
            stars = (("?m", ((P_VALUE, "?v"),), MEASUREMENT),)
        out.append(BGPQueryRequest(rid=rid0 + i, stars=stars,
                                   filters=filters))
    return out


def unique_rows(rows):
    """The sorted, unique rows of a 2-D integer array (a lexsort and a
    comparison of neighbours: ``np.unique(axis=0)`` sorts a void view,
    several times slower on a million rows)."""
    import numpy as np
    rows = rows[np.lexsort(rows.T[::-1])]
    keep = np.ones(rows.shape[0], bool)
    keep[1:] = np.any(rows[1:] != rows[:-1], axis=1)
    return rows[keep]


def response_rows(resp, d):
    """A response's bindings as canonical id rows (sorted, unique)."""
    import itertools
    import numpy as np
    if resp.n_rows == 0:
        return np.empty((0, 0), np.int64)
    if hasattr(resp, "subjects"):
        rows = ((s,) + o for s, o in zip(resp.subjects, resp.var_objects))
        width = 1 + len(resp.var_props)
    else:
        rows, width = resp.rows, len(resp.variables)
    flat = itertools.chain.from_iterable(rows)
    ids = np.fromiter(map(d.lookup, flat), np.int64,
                      count=resp.n_rows * width).reshape(-1, width)
    return unique_rows(ids)


def same_rows(a, b) -> bool:
    """Two canonical binding arrays hold the same rows (any empty two
    agree, whatever their width)."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return a.shape[0] == b.shape[0]
    return a.shape == b.shape and a.tobytes() == b.tobytes()


class TripleScan:
    """Star queries answered by a plain scan of a store's triples, apart
    from the query package: the rows grouped by predicate once, each
    predicate's rows sorted by (subject, object) once, then per arm a
    mask over them, subject sets intersected, and each variable arm
    joined on by a sorted search."""

    def __init__(self, store):
        import numpy as np
        spo = store.spo.astype(np.int64)
        self.spo = spo[np.argsort(spo[:, 1], kind="stable")]
        self.type_id = store.TYPE
        self.blocks: dict = {}
        self.classes: dict = {}

    def _pred(self, p: int):
        """The (subject, object) pairs of predicate ``p``, sorted."""
        import numpy as np
        if p not in self.blocks:
            lo, hi = np.searchsorted(self.spo[:, 1], [p, p + 1])
            s, o = self.spo[lo:hi, 0], self.spo[lo:hi, 2]
            order = np.lexsort((o, s))
            self.blocks[p] = (s[order], o[order])
        return self.blocks[p]

    def star(self, q):
        """Sorted-unique rows (subject, then the variable arms' objects in
        arm order) of the star query ``q``, which has a class."""
        import numpy as np
        if q.class_id not in self.classes:
            s, o = self._pred(self.type_id)
            self.classes[q.class_id] = np.unique(s[o == q.class_id])
        subs = self.classes[q.class_id]
        for p, obj in q.arms:
            if obj is not None:
                s, o = self._pred(p)
                hit = s[o == obj]            # sorted, unique
                at = np.searchsorted(subs, hit).clip(0, len(subs) - 1)
                subs = hit[subs[at] == hit] if len(subs) else subs
        rows = subs[:, None]
        for p, obj in q.arms:
            if obj is None:
                s, o = self._pred(p)
                lo = np.searchsorted(s, rows[:, 0], "left")
                n = np.searchsorted(s, rows[:, 0], "right") - lo
                starts = np.repeat(lo, n)
                offs = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
                rows = np.column_stack([np.repeat(rows, n, axis=0),
                                        o[starts + offs]])
        return unique_rows(rows)


def graph_server(store, snap, totals) -> dict:
    """Phase 4g (b): ``GraphQueryService`` at 10M, three waves; returns
    the ``auto`` wave's responses (phase 4h(e) holds the sharded service
    to them)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.query import eval_bgp_reference, eval_raw
    from repro_torch.serving import GraphQueryService
    from repro_torch.serving.engine import _compile_bgp_query, _compile_star

    d = snap.store.dict
    rng = np.random.default_rng(SEED)
    stars = graph_star_requests(snap.fgraph, d, GRAPH_STAR_REQUESTS, rng)
    bgps = graph_bgp_requests(snap.fgraph, d, GRAPH_BGP_REQUESTS,
                              GRAPH_STAR_REQUESTS, rng)
    mem_start = device_peak_start()
    svc = GraphQueryService(snap, backend="device")
    t0 = time.perf_counter()
    raw = svc.engine.raw_store
    t_expand = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw.index
    t_index = time.perf_counter() - t0
    log(f"graph server: expand() of the {snap.n_triples}-triple G' for the "
        f"raw strategy {t_expand:.2f} s ({raw.n_triples} triples), its "
        f"index {t_index:.2f} s (once, before the waves)")
    waves, launches = {}, {}
    for wave in ("raw", "factorized", "auto"):
        star_strategy = "raw" if wave == "raw" else "factorized"
        for r in stars:
            assert svc.submit(dataclasses.replace(r, strategy=star_strategy))
        for r in bgps:
            assert svc.submit(dataclasses.replace(r, strategy=wave))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        waves[wave] = svc.run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches[wave] = add_launches(
            totals, f"the {wave} wave", () if wave == "raw" else
            ("sig_hash",))
        rows = sum(r.n_rows for r in waves[wave].values())
        log(f"graph server wave {wave}: {len(stars)} star + {len(bgps)} "
            f"BGP requests in {ms:.1f} ms, {rows} binding rows, launches "
            f"{launches[wave]}")
    peak = device_peak(mem_start)
    m = svc.metrics.summary()
    for ch in ("wave.raw_fallback", "admission.shed", "wave.deadline_shed"):
        assert m[ch]["count"] == 0, f"graph server: {ch} {m[ch]}"
    mix = {"raw": 0, "factorized": 0}
    ref_cache: dict = {}
    star_rows: dict = {}          # the star requests' answers, as id rows
    t0 = time.perf_counter()
    for req in stars + bgps:
        got = [waves[w][req.rid] for w in waves]
        assert all(r.status == "ok" for r in got), \
            (req.rid, [r.status for r in got])
        rows = [response_rows(r, d) for r in got]
        assert all(same_rows(r, rows[0]) for r in rows), \
            f"request {req.rid}: the waves' binding sets differ"
        if hasattr(req, "arms"):
            q = _compile_star(req, d)
            oracle = (lambda q=q: eval_raw(store, q))
            star_rows[req.rid] = (q, rows[0])
        else:
            q = _compile_bgp_query(req, d)
            oracle = (lambda q=q: eval_bgp_reference(store, q))
            for s in got[-1].strategies:
                mix[s] += 1
        if q is None:
            assert rows[0].shape[0] == 0, req.rid
            continue
        if q not in ref_cache:
            ref_cache[q] = oracle().canonical()
        want = ref_cache[q]
        assert same_rows(rows[0], want), \
            f"request {req.rid} differs from its oracle on the original store"
    log(f"graph server: every response ok, no raw fallback or shed; the "
        f"three waves' binding sets identical and equal to eval_raw / "
        f"eval_bgp_reference on the original store ({len(ref_cache)} "
        f"distinct queries, checked in {time.perf_counter() - t0:.1f} s); "
        f"planner per-star mix {mix}; device memory peak {peak} B over the "
        "phase's start")
    # the star answers once more, against a scan of the original triples
    # that shares no code with the query package
    t0 = time.perf_counter()
    scan = TripleScan(store)
    for rid, (q, rows) in star_rows.items():
        if q is None:
            continue
        assert waves["factorized"][rid].var_props == \
            tuple(d.term(p) for p in q.var_props), rid
        assert same_rows(rows, scan.star(q)), \
            f"star request {rid} differs from a scan of the triples"
    log(f"graph server: {len(star_rows)} star answers equal a plain scan of "
        f"the original triples ({time.perf_counter() - t0:.1f} s)")
    return waves["auto"]


def graph_entry_points(totals) -> None:
    """Phase 4g (c): the ported entry points on the device backend, and
    ``--online --durable DIR --chaos`` killed and restarted."""
    import os
    import signal
    import tempfile
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    for name, call, need in (
            ("serve_graph_queries", lambda: serve.serve_graph_queries(
                ENTRY_STAR_REQUESTS, backend="device"), ("sig_hash",)),
            ("serve_bgp_queries", lambda: serve.serve_bgp_queries(
                ENTRY_BGP_REQUESTS, backend="device"), ("sig_hash",)),
            ("serve_online", lambda: serve.serve_online(
                ENTRY_ONLINE_BATCHES, backend="device"),
             ("sig_hash", "seg_count"))):
        t0 = time.perf_counter()
        res = call()
        secs = time.perf_counter() - t0
        launched = add_launches(totals, name, need)
        brief = {k: v for k, v in res.items()
                 if k not in ("rows", "metrics")}
        log(f"entry point {name}: {secs:.2f} s, launches {launched}, {brief}")
    # the subprocesses load this run's kernel library from the default
    # build directory instead of compiling it again
    lib = build.build()
    dst = ROOT / "build" / "repro_torch_kernels"
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy2(lib, dst / lib.name)
    root = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--online",
           "--durable", root, "--chaos", str(CHAOS_SEED)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    try:
        for attempt, want in (("first", -signal.SIGKILL), ("restart", 0)):
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=300)
            secs = time.perf_counter() - t0
            last = (res.stdout.strip().splitlines() or [""])[-1]
            log(f"--online --durable --chaos {CHAOS_SEED}, {attempt} run: "
                f"exit {res.returncode} in {secs:.1f} s; {last}")
            assert res.returncode == want, \
                f"{attempt} run exited {res.returncode}:\n{res.stderr[-2000:]}"
        assert "online soak (recovery)" in last and "gates PASS" in last, last
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bgp_and_graph_server(store, snap, totals) -> dict:
    """Phase 4g: (a), (b) and (c); returns (b)'s ``auto`` wave."""
    reset_launches()
    t0 = time.perf_counter()
    bgp_matrix(totals)
    log(f"bgp matrix: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    auto_wave = graph_server(store, snap, totals)
    log(f"graph server: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    graph_entry_points(totals)
    log(f"graph entry points: {time.perf_counter() - t0:.1f} s")
    return auto_wave


# ---------------------------------------------------------------------------
# phase 4h: the sharded backend and the sharded graph
# ---------------------------------------------------------------------------

# 4h: phase 3's 10M store sharded 4 ways on the one card (every mesh entry
# is the card, so the exchange is a permutation on it); (a) the exchange
# also on 8 entries, at the default headroom and one that overflows, a
# slice of the Observation bucket held against the same call on a CPU
# mesh (the kernels' plain versions)
SHARDS = 4
EXCHANGE_SHARDS = (4, 8)
EXCHANGE_CAPS = (4.0, 0.25)
EXCHANGE_CPU_ROWS = 1 << 19


def drop_one_masks(k: int, kb: int):
    """The sweep's (kb, kb) drop-one stack over k active columns of a
    kb-wide bucket (rows from k on are the no-op full candidate)."""
    import numpy as np
    masks = np.zeros((kb, kb), np.int32)
    masks[:, :k] = 1
    masks[np.arange(k), np.arange(k)] = 0
    return masks


def sharded_exchange(store, dev, totals) -> None:
    """Phase 4h (a): ``ami_bucketed_batch`` at the gfsp sweep's shape."""
    import numpy as np
    import torch
    from repro_torch.core.distributed import (EXCHANGE_STATS,
                                              ami_bucketed_batch,
                                              reset_exchange_stats)
    from repro_torch.core.star import ami_device_batch
    from repro_torch.core.sweep import bucket_cols, bucket_rows
    from repro_torch.data.synthetic import OBSERVATION
    from repro_torch.dist.mesh import make_mesh

    cid = store.dict.lookup(OBSERVATION)
    props = sorted(int(p) for p in store.class_properties(cid))
    _, mat = store.object_matrix(cid, props)
    n, k = mat.shape
    nb, kb = bucket_rows(n, max(EXCHANGE_SHARDS)), bucket_cols(k)
    buf = np.zeros((nb, kb), np.int32)
    buf[:n, :k] = mat
    valid = np.arange(nb) < n
    masks = drop_one_masks(k, kb)
    on = [torch.from_numpy(x).to(dev) for x in (buf, valid, masks)]
    # the one-device sweep's counts, before the phase's launches count
    want = ami_device_batch(on[0], valid=on[1], col_masks=on[2]).tolist()
    reset_launches()
    for shards in EXCHANGE_SHARDS:
        mesh = make_mesh((shards,), ("data",), dev)
        reset_exchange_stats()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ami_bucketed_batch(*on, mesh).tolist()
        ms = (time.perf_counter() - t0) * 1e3
        assert got == want, (shards, got, want)
        log(f"exchange {shards}-way at ({nb}, {kb}) x {kb}: {ms:.1f} ms, "
            f"{EXCHANGE_STATS['bytes']} B sent, amis {got} == the "
            "one-device sweep's")
    rows = min(EXCHANGE_CPU_ROWS, nb)
    part = [torch.from_numpy(x) for x in (buf[:rows], valid[:rows])]
    exact = ami_device_batch(part[0], valid=part[1],
                             col_masks=torch.from_numpy(masks)).tolist()
    for shards in EXCHANGE_SHARDS:
        for cap in EXCHANGE_CAPS:
            reset_exchange_stats()
            got = ami_bucketed_batch(
                part[0].to(dev), part[1].to(dev), on[2],
                make_mesh((shards,), ("data",), dev),
                cap_factor=cap).tolist()
            dropped = EXCHANGE_STATS["dropped"]
            plain = ami_bucketed_batch(
                *part, masks, make_mesh((shards,), ("data",), "cpu"),
                cap_factor=cap).tolist()
            assert got == plain, (shards, cap, got, plain)
            if cap == 4.0:
                assert got == exact and dropped == 0, (got, exact)
            else:
                assert dropped > 0 and got != exact, "nothing overflowed"
            log(f"exchange {shards}-way at ({rows}, {kb}) x {kb}, headroom "
                f"{cap}: {dropped} signatures overflowed, amis {got} == "
                "the CPU mesh's")
    log(f"exchange launches: "
        f"{add_launches(totals, '4h(a)', ('sig_hash', 'seg_count'))}")


def sharded_backend(store, runs, dev, totals) -> None:
    """Phase 4h (b): ``Compactor(..., "sharded")`` on a 4-way mesh of the
    card, its plans and G' against phase 3's device runs."""
    import torch
    from repro_torch.api import Compactor
    from repro_torch.core import sweep
    from repro_torch.core.distributed import EXCHANGE_STATS
    from repro_torch.dist.mesh import make_mesh

    mesh = make_mesh((SHARDS,), ("data",), dev)
    gd_comp, gd, _ = runs[("gfsp", "device")]
    comp = Compactor("gfsp", "sharded", backend_opts={"mesh": mesh})
    sweep.reset_trace_stats()
    reset_launches()
    t0 = time.perf_counter()
    plan = comp.plan(store)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    report = comp.execute(store, plan)
    secs = time.perf_counter() - t0
    launched = add_launches(totals, "4h(b) gfsp/sharded",
                            ("sig_hash", "seg_count"))
    assert plan_rows(report) == plan_rows(gd), "gfsp sharded != device plan"
    g = sha1(report.graph.spo)
    assert g == sha1(gd.graph.spo), "gfsp sharded G' != device G'"
    digest = comp.snapshot.digest()
    assert digest == gd_comp.snapshot.digest()
    lpd = sweep.lowerings_per_descent()
    log(f"sharded backend gfsp ({SHARDS}-way): {secs:.2f} s (plan "
        f"{t_plan:.2f} s), launches {launched}, lowerings/descent {lpd:.3f}, "
        f"exchanges {EXCHANGE_STATS['calls']} of "
        f"{EXCHANGE_STATS['bytes']} B, bucket shapes "
        f"{sorted(sweep.TRACE_COUNTS)}; plans, G' sha1 {g} and digest "
        f"{digest} equal phase 3's device run")
    ed = runs[("efsp", "device")][1]
    comp = Compactor("efsp", "sharded", backend_opts={"mesh": mesh})
    t0 = time.perf_counter()
    plan = comp.plan(store)
    secs = time.perf_counter() - t0
    launched = add_launches(totals, "4h(b) efsp/sharded",
                            ("sig_hash", "seg_count"))
    assert plan_rows(types.SimpleNamespace(plan=plan)) == plan_rows(ed), \
        "efsp sharded != device plan"
    log(f"sharded backend efsp plan: {secs:.2f} s, launches {launched}; "
        "plans equal phase 3's device run")


def sharded_graph(store, snap, dev, totals):
    """Phase 4h (c): the 10M store partitioned into 4 shards, detected on
    the card shard by shard, the split classes counted by the exchange."""
    import numpy as np
    from repro_torch.core.distributed import (EXCHANGE_STATS,
                                              reset_exchange_stats)
    from repro_torch.core.star import ami
    from repro_torch.dist.graph import ShardedFactorizedGraph
    from repro_torch.dist.mesh import make_mesh

    t0 = time.perf_counter()
    sh = ShardedFactorizedGraph.partition(store, SHARDS)
    t_part = time.perf_counter() - t0
    reset_launches()
    reset_exchange_stats()
    t0 = time.perf_counter()
    rep = sh.detect_all(backend="device", device=dev,
                        mesh=make_mesh((SHARDS,), ("data",), dev))
    secs = time.perf_counter() - t0
    launched = add_launches(totals, "4h(c)", ("sig_hash", "seg_count"))
    assert sh.plan.split_classes, "no class crosses shards"
    for cid, got in rep["split_class_ami"].items():
        props = np.asarray(sh.plan.class_props[cid], np.int32)
        want = ami(store.object_matrix(cid, props)[1])
        assert got == want, (cid, got, want)
    t0 = time.perf_counter()
    digest = sh.digest()
    t_digest = time.perf_counter() - t0
    assert digest == snap.digest(), "sharded digest != phase 3's"
    log(f"sharded graph: partition into {SHARDS} in {t_part:.2f} s "
        f"(weights {list(sh.plan.shard_weights)}, {sh.plan.n_chunks} "
        f"chunks), detect_all on the card {secs:.2f} s, launches "
        f"{launched}; split classes' AMI {rep['split_class_ami']} by the "
        f"exchange ({EXCHANGE_STATS['bytes']} B sent) == the host count; "
        f"digest {digest} == phase 3's ({t_digest:.2f} s)")
    for sid, r in sorted(rep["shards"].items()):
        log(f"  shard {sid}: {r}")
    log(f"sharded graph: traffic {sh.traffic}, resident bytes per shard "
        f"{sh.shard_nbytes()}, {sh.n_triples} triples stored")
    return sh


def shard_cell_queries(fg) -> list:
    """``benchmarks/shard_cell.py``'s 64 star queries over a G'."""
    from repro_torch.query import StarQuery
    queries = []
    for cid, t in sorted(fg.tables.items()):
        for row in t.objects[:24]:
            queries.append(StarQuery(arms=tuple(
                (int(p), int(o)) for p, o in zip(t.props, row)),
                class_id=cid))
        for row in t.objects[:8]:
            queries.append(StarQuery(arms=((int(t.props[0]), int(row[0])),
                                           (int(t.props[-1]), None)),
                                     class_id=cid))
    return queries


def shard_matrix(dev, totals) -> None:
    """Phase 4h (d): ``BENCH_fsp.json``'s eight ``shard_matrix`` cells on
    the card, against their recorded digests, AMIs, traffic and weights."""
    from repro_torch.api import CompactionPlanner
    from repro_torch.data.synthetic import WorkloadSpec, generate_workload
    from repro_torch.dist.graph import ShardedFactorizedGraph, \
        ShardedQueryEngine
    from repro_torch.dist.mesh import make_mesh

    cells = json.loads((ROOT / "BENCH_fsp.json").read_text())[
        "shard_matrix"]["cells"]
    assert len(cells) == 8, len(cells)
    # the one-device reference compactions, before the phase's launches
    # count: only the sharded path's count
    refs = {}
    for size in sorted({c["n_triples"] for c in cells}):
        spec = WorkloadSpec(shape="sensor", n_triples=round(size, -5),
                            seed=cells[0]["seed"])
        snap, _ = CompactionPlanner(
            "gfsp", "device", backend_opts={"device": dev}).run(
            generate_workload(spec))
        refs[size] = spec, snap
    reset_launches()
    for size, (spec, snap) in refs.items():
        queries = shard_cell_queries(snap.fgraph)
        for cell in sorted((c for c in cells if c["n_triples"] == size),
                           key=lambda c: c["devices"]):
            n = cell["devices"]
            t0 = time.perf_counter()
            store = generate_workload(spec)
            assert store.n_triples == size
            sh = ShardedFactorizedGraph.partition(store, n, oversplit=4)
            # the split classes' AMI by the exchange on an n-way mesh
            rep = sh.detect_all(backend="device", device=dev,
                                mesh=make_mesh((n,), ("data",), dev)
                                if n > 1 else None)
            digest = sh.digest()
            collective = {store.dict.term(cid): got for cid, got in
                          rep["split_class_ami"].items()} if n > 1 else {}
            eng = ShardedQueryEngine(sh, device=dev)
            cold = eng.query_batch(queries, backend="device")
            warm = eng.query_batch(queries, backend="device")
            secs = time.perf_counter() - t0
            got = {"detect_digest": digest, "query_digest": bgp_digest(warm),
                   "collective_ami": collective,
                   "traffic": dict(sh.traffic),
                   "shard_weights": list(sh.plan.shard_weights),
                   "split_classes": len(sh.plan.split_classes),
                   "shard_resident_bytes": sh.shard_nbytes(),
                   "n_queries": len(queries),
                   "query_rows": sum(b.n_rows for b in warm)}
            assert bgp_digest(cold) == got["query_digest"]
            assert snap.digest() == digest
            want = {k: cell[k] for k in got}
            assert got == want, f"shard cell {n} x {size}: {got} != {want}"
            log(f"shard matrix {n} x {size}: {secs:.2f} s, digest {digest}, "
                f"query digest {got['query_digest']}, collective "
                f"{collective}, traffic {got['traffic']}, weights "
                f"{got['shard_weights']}: all equal BENCH_fsp.json's")
    log(f"shard matrix launches: "
        f"{add_launches(totals, '4h(d)', ('sig_hash', 'seg_count'))}")


def sharded_wave(snap, sh, want, dev, totals) -> None:
    """Phase 4h (e): 4g(b)'s ``auto`` wave of star and BGP requests
    through ``ShardedQueryService`` over 4h(c)'s shards, against the
    responses of the replicated ``GraphQueryService`` over phase 3's
    snapshot in 4g(b) (``want``)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.serving import ShardedQueryService

    d = snap.store.dict
    rng = np.random.default_rng(SEED)
    stars = graph_star_requests(snap.fgraph, d, GRAPH_STAR_REQUESTS, rng)
    bgps = graph_bgp_requests(snap.fgraph, d, GRAPH_BGP_REQUESTS,
                              GRAPH_STAR_REQUESTS, rng)
    # the requests of 4g(b)'s auto wave: stars factorized, BGPs planned
    reqs = [dataclasses.replace(r, strategy="factorized") for r in stars] \
        + [dataclasses.replace(r, strategy="auto") for r in bgps]
    assert sorted(want) == sorted(r.rid for r in reqs)
    svc = ShardedQueryService(sh, device=dev)
    for r in reqs:
        assert svc.submit(r), f"request {r.rid} shed"
    reset_launches()
    t0 = time.perf_counter()
    out = svc.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = add_launches(totals, "4h(e)")
    m = svc.metrics.summary()
    for ch in ("wave.raw_fallback", "admission.shed", "wave.deadline_shed"):
        assert m[ch]["count"] == 0, f"sharded wave: {ch} {m[ch]}"
    bad = {rid: r.status for rid, r in out.items() if r.status != "ok"}
    assert not bad, f"sharded wave: responses not ok {bad}"
    rows = sum(r.n_rows for r in out.values())
    log(f"sharded wave: {len(stars)} star + {len(bgps)} BGP requests over "
        f"{sh.n_shards} shards in {ms:.1f} ms, {rows} binding rows, launches "
        f"{launched}")
    t0 = time.perf_counter()
    for r in reqs:
        a, b = want[r.rid], out[r.rid]
        if hasattr(a, "subjects"):
            assert a.var_props == b.var_props and \
                sorted(zip(a.subjects, a.var_objects)) == \
                sorted(zip(b.subjects, b.var_objects)), r.rid
        else:
            assert a.variables == b.variables and \
                sorted(a.rows) == sorted(b.rows), r.rid
    log(f"sharded wave: every response ok, no fallback or shed, each equal "
        f"to 4g(b)'s replicated auto wave ({time.perf_counter() - t0:.1f} "
        f"s); traffic {sh.traffic}")


def sharded_entry_point() -> None:
    """Phase 4h (f): ``python -m repro_torch.launch.serve --sharded 4``."""
    import os
    from repro_torch.kernels import build

    lib = build.build()
    dst = ROOT / "build" / "repro_torch_kernels"
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy2(lib, dst / lib.name)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--sharded",
           str(SHARDS)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ,
                                               PYTHONPATH=str(ROOT / "src")))
    last = (res.stdout.strip().splitlines() or [""])[-1]
    assert res.returncode == 0, \
        f"--sharded exited {res.returncode}:\n{res.stderr[-2000:]}"
    assert last.startswith("sharded endpoint"), last
    log(f"--sharded {SHARDS}: exit 0 in {time.perf_counter() - t0:.1f} s; "
        f"{last}")


def sharded(store, runs, snap, auto_wave, dev, totals) -> None:
    """Phase 4h: (a)-(f), each timed."""
    def timed(what, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"{what}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("exchange", sharded_exchange, store, dev, totals)
    timed("sharded backend", sharded_backend, store, runs, dev, totals)
    sh = timed("sharded graph", sharded_graph, store, snap, dev, totals)
    timed("shard matrix", shard_matrix, dev, totals)
    timed("sharded wave", sharded_wave, snap, sh, auto_wave, dev, totals)
    timed("sharded entry point", sharded_entry_point)


# ---------------------------------------------------------------------------
# phase 5: parity and timing at the main path's shapes
# ---------------------------------------------------------------------------

def with_bound(rec: dict) -> dict:
    """Turns ``rec["bound"]`` (bytes ms, operations ms) into ``bound_ms``
    and ``bound_by``, and logs the record."""
    by_bytes, by_ops = rec.pop("bound")
    rec["bound_ms"] = max(by_bytes, by_ops)
    rec["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    lib = rec["library_ms"]
    log(f"timing {rec['name']} at {rec['shape']}: kernel {rec['ms']:.4f} ms, "
        f"plain {rec['plain_ms']:.4f} ms, library "
        f"{'none' if lib is None else f'{lib:.4f}'} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; bytes {by_bytes:.4f} "
        f"ms, operations {by_ops:.4f} ms)")
    return rec


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
    # the work the kernel must do: it hashes only valid rows (the rest get
    # the sentinel) and reads only the valid rows of the parent, once for
    # all candidates; every signature, sentinels too, is written
    valid = kw["valid"]
    n_valid = int(valid.sum())
    sig_bytes = (n_valid * k_b * 4 + valid.numel() + c_b * k_b * 4 +
                 c_b * n_b * 8)
    # per row and column, both lanes: 3 IMAD + 3 ALU (mul, rotl, mul;
    # xor, rotl, mul-add) per lane, plus the mask multiply (IMAD) and
    # the hi lane's seed xor (ALU); per lane fmix32(h ^ K): 2 IMAD, 7 ALU
    sig_imad = c_b * n_valid * (7 * k_b + 4)
    sig_alu = c_b * n_valid * (7 * k_b + 14)
    # the count before it (every row hashed, the parent read once): the
    # INT32 pipe's time for all c_b * n_b rows
    log(f"sig_hash bound over all {n_b} rows, as counted before: "
        f"{c_b * n_b * (7 * k_b + 14) / INT32_PIPE_OPS_PER_S * 1e3:.4f} ms "
        f"(operations); over the {n_valid} valid rows: bytes "
        f"{sig_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, operations "
        f"{max(sig_imad, sig_alu) / INT32_PIPE_OPS_PER_S * 1e3:.4f} ms")
    out["sig_hash"] = dict(
        shape=f"parent ({n_b}, {k_b}) int32, masks ({c_b}, {k_b}), "
              f"valid ({n_b},) with {n_valid} set -> ({c_b}, {n_b}, 2) "
              "uint32",
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
    return {name: with_bound(dict(name=name, **rec))
            for name, rec in out.items()}


# ---------------------------------------------------------------------------
# phase 6: parity of the LM kernels on random inputs
# ---------------------------------------------------------------------------

def float_case(name: str, got, want, what: str, limit=None) -> float:
    """Max |got - want| of a float kernel against its plain version,
    held to ``limit`` (flash in bf16: a (..., T, 1) tensor of row limits)
    or else the tolerance of the output dtype; any excess fails."""
    import torch
    torch.cuda.synchronize()
    dt = str(want.dtype).removeprefix("torch.")
    assert got.dtype == want.dtype and got.shape == want.shape, what
    tol = TOL[name][dt] if limit is None else limit
    delta = (got.float() - want.float()).abs()
    e = float(delta.max()) if got.numel() else 0.0
    ok = bool((delta <= tol).all())
    if limit is not None and got.numel():
        worst = float((delta.amax(-1, keepdim=True) /
                       limit.clamp_min(1e-30)).max())
        tol = float(limit.max())
        log(f"  flash {what}: max |delta| {e:.4g}, max |want| "
            f"{float(want.float().abs().max()):.4g}, row limits "
            f"{float(limit[limit > 0].min()):.4g}..{tol:.4g}, worst row "
            f"{worst:.3f} of its limit")
    elif name == "flash_attention_f32":
        log(f"  flash {what}: max |delta| {e:.4g}, tolerance {tol:.4g}")
    assert ok, f"{name} disagrees with its plain version: {what} " \
        f"max |delta| {e}"
    ERR[name] = max(ERR[name], e)
    LIMIT[name] = max(LIMIT[name], float(tol))
    CASES[name] += 1
    return e


def flash_case(q, k, v, kw: dict, what: str, control: bool = False
               ) -> float:
    """``flash_attention`` against its plain version (bf16: within each
    row's limit).  With ``control``, a wrong kernel must break the same
    limits: the plain version with the 64-key KV tile at the middle of S
    (attended by the rows after it) left out of PV, its V zeroed."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (bf16_row_limit,
                                                     flash_attention,
                                                     flash_attention_plain)
    want = flash_attention_plain(q, k, v, **kw)
    limit = (bf16_row_limit(q, k, v, want, steps=FLASH_BF16_STEPS, **kw)
             if q.dtype == torch.bfloat16 else None)
    route = ("flash_attention" if q.dtype == torch.bfloat16
             else "flash_attention_f32")
    e = float_case(route, flash_attention(q, k, v, **kw), want, what, limit)
    if control:
        s = k.shape[2]
        lo = s // 2 // 64 * 64
        lost = v.clone()
        lost[:, :, lo:lo + 64] = 0
        delta = (flash_attention_plain(q, k, lost, **kw).float() -
                 want.float()).abs().amax(-1, keepdim=True)
        over = delta > limit
        seeing = ref.attention_mask(q.shape[2], s, kw.get("causal", True),
                                    kw.get("window"), q.device)[
            :, lo:lo + 64].any(-1)
        log(f"  control: keys [{lo}, {lo + 64}) left out of PV: max |delta| "
            f"{float(delta.max()):.4g}, {int(over.sum())} of "
            f"{int(seeing.sum()) * q.shape[0] * q.shape[1]} rows that "
            f"attend them over their limit, the closest "
            f"{float((delta / limit.clamp_min(1e-30))[..., seeing, :].min()):.3f}"
            " times its limit")
        assert bool(over.any()), "the bf16 limit cannot see a lost KV tile"
    return e


def scan_case(x, a, h0, what: str) -> float:
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_plain
    (hs, last), (phs, plast) = (linear_scan(x, a, h0),
                                linear_scan_plain(x, a, h0))
    return max(float_case("linear_scan", hs, phs, what + " states"),
               float_case("linear_scan", last, plast, what + " final"))


# (B, Hq, Hkv, T, S, D, causal, window)
FLASH_CASES = [(2, 4, 4, 64, 64, 64, True, None),        # group 1
               (2, 4, 2, 77, 77, 64, False, None),       # group 2, ragged
               (1, 10, 1, 300, 1000, 256, True, 128),    # group 10, T < S
               (1, 4, 2, 37, 130, 64, False, 40),        # window, no causal
               (1, 2, 1, 70, 20, 64, True, None),        # T > S: masked rows
               (2, 10, 1, 333, 333, 256, True, 100),     # ragged, window
               (2, 4, 4, 64, 64, 128, True, None),       # D 128, group 1
               (2, 4, 2, 77, 77, 128, False, None),      # group 2, ragged
               (1, 4, 2, 100, 300, 128, True, None),     # T < S
               (1, 4, 4, 130, 70, 128, False, 40),       # T > S, window
               (2, 4, 2, 201, 333, 128, True, None),     # ragged T < S
               (1, 16, 4, 96, 160, 128, True, None),     # group 4, T < S
               (1, 12, 2, 65, 129, 128, False, None),    # group 6
               (1, 16, 2, 100, 100, 128, True, None),    # group 8
               (1, 16, 1, 77, 200, 128, False, None)]    # group 16
# (B, T, D, h0)
SCAN_CASES = [(8, 1, 2560, True), (8, 1, 2560, False), (3, 77, 300, True),
              (2, 1000, 129, False), (1, 2048, 2560, False)]


def lm_kernel_parity(dev) -> None:
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, hq, hkv, t, s, d, causal, window in FLASH_CASES:
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev, dtype)
                for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d)))
            what = (f"{dtype} q {tuple(q.shape)} kv {tuple(k.shape)} "
                    f"causal={causal} window={window}")
            e = flash_case(q, k, v, {"causal": causal, "window": window},
                           what)
            key = ("flash_attention" if dtype == torch.bfloat16
                   else "flash_attention_f32", str(dtype))
            worst[key] = max(worst.get(key, 0.0), e)
        for b, t, d, with_h0 in SCAN_CASES:
            x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(
                np.float32)).to(dev, dtype)
            a = torch.from_numpy(rng.uniform(0.5, 1.0, (b, t, d)).astype(
                np.float32)).to(dev, dtype)
            h0 = (torch.from_numpy(rng.standard_normal((b, d)).astype(
                np.float32)).to(dev) if with_h0 else None)
            e = scan_case(x, a, h0, f"{dtype} x {tuple(x.shape)} "
                                    f"h0={with_h0}")
            key = ("linear_scan", str(dtype))
            worst[key] = max(worst.get(key, 0.0), e)
    for (name, dt), e in sorted(worst.items()):
        tol = TOL.get(name, {}).get(dt.removeprefix("torch."),
                                    "the row limits")
        log(f"parity: {name} {dt}: max |delta| {e:.3g} (tolerance {tol})")
    log(f"parity: flash_attention {CASES['flash_attention']} bf16 and "
        f"{CASES['flash_attention_f32']} float32 cases, linear_scan "
        f"{CASES['linear_scan']} cases, all within tolerance")


# ---------------------------------------------------------------------------
# phase 7: the LM serve path at full width
# ---------------------------------------------------------------------------

class Recorder:
    """Wraps ``ops.attention`` and ``ops.linear_scan`` (what the blocks
    call) and keeps a copy of the inputs of the first call of each
    distinct shape; the wrapped call itself runs unchanged."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.orig = {"attention": ops.attention,
                     "linear_scan": ops.linear_scan}
        self.flash: dict = {}
        self.scan: dict = {}

    def _attention(self, q, k, v, **kw):
        key = (tuple(q.shape), tuple(k.shape), str(q.dtype),
               tuple(sorted(kw.items())))
        if key not in self.flash:
            self.flash[key] = (q.clone(), k.clone(), v.clone(), dict(kw))
        return self.orig["attention"](q, k, v, **kw)

    def _linear_scan(self, x, a, h0=None):
        key = (tuple(x.shape), str(x.dtype), h0 is None)
        if key not in self.scan:
            self.scan[key] = (x.clone(), a.clone(),
                              None if h0 is None else h0.clone())
        return self.orig["linear_scan"](x, a, h0)

    def __enter__(self):
        self.ops.attention = self._attention
        self.ops.linear_scan = self._linear_scan
        return self

    def __exit__(self, *exc):
        self.ops.attention = self.orig["attention"]
        self.ops.linear_scan = self.orig["linear_scan"]


def profile_window(label: str, fn) -> None:
    """Run ``fn`` under ``torch.profiler`` and log the device's busy time
    against the wall time and the kernels that took most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e6
    busy = sum(by_name.values())
    log(f"profile {label}: {len(by_name)} kernel names, device busy "
        f"{busy:.4f} s of {wall:.4f} s wall under the profiler (idle share "
        f"{1 - busy / wall:.3f})")
    for name, secs in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {secs * 1e3:9.3f} ms  {name[:110]}")


def lm_layers(cfg) -> str:
    """The layer kinds of ``cfg`` with their counts, e.g. "18 rglru + 8
    local"."""
    return " + ".join(f"{cfg.pattern.count(k)} {k}"
                      for k in dict.fromkeys(cfg.pattern))


def build_lm(cfg, dev):
    """``cfg``'s LM on the card with weights drawn from ``SEED``; logs
    its shape, parameters and memory."""
    import torch
    from repro_torch.models import LM

    t0 = time.perf_counter()
    model = LM(cfg, device=dev,
               generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    mixer = (f"ssd heads {cfg.ssm_heads} x {cfg.ssm_head_dim}, state "
             f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}"
             if "ssd" in cfg.pattern else
             f"heads {cfg.n_heads}/{cfg.n_kv_heads} x "
             f"{cfg.resolved_head_dim}, ff {cfg.d_ff}, window {cfg.window}")
    if cfg.n_experts:
        mixer += (f", {cfg.n_experts} experts top-{cfg.experts_per_token} "
                  f"of ff {cfg.moe_d_ff}")
    if cfg.encoder_layers:
        mixer += f", encoder {cfg.encoder_layers} layers"
    if cfg.frontend != "none":
        mixer += (f", {cfg.frontend} {cfg.frontend_tokens} x "
                  f"{cfg.frontend_dim or cfg.d_model}")
    log(f"lm: {cfg.name} [{cfg.family}], {cfg.n_layers} layers "
        f"({lm_layers(cfg)}), d {cfg.d_model}, {mixer}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}: {n_params} parameters "
        f"(n_params {cfg.n_params}), "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def lm_serve(dev, arch: str):
    """Phase 7 (recurrentgemma-2b), 7c (qwen2-0.5b, mamba2-780m) and 7d
    (moonshot-v1-16b-a3b): the LM serve path of ``arch`` at full width
    (7c's at the depth of ``LM_DEPTH``).  Returns (launch counts of the run, the recorder)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.serving import Engine, Request

    cfg = get_arch(arch)
    if arch in LM_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=LM_DEPTH[arch])
    n_attn = sum(k in ("attn", "local") for k in cfg.pattern)
    n_rglru = cfg.pattern.count("rglru")
    n_ssd = cfg.pattern.count("ssd")
    model = build_lm(cfg, dev)
    rng = np.random.default_rng(SEED)
    system = rng.integers(1, cfg.vocab_size, LM_SHARED, dtype=np.int32)
    prompts = [np.concatenate([system, rng.integers(
        1, cfg.vocab_size, LM_OWN, dtype=np.int32)])
        for _ in range(LM_REQUESTS)]
    length = LM_SHARED + LM_OWN
    cache_len = length + LM_NEW

    def serve(policy):
        eng = Engine(model, cache_len=cache_len, chunk=LM_CHUNK,
                     policy=policy, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new=LM_NEW))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        outs = eng.run(keep_logits=True)
        torch.cuda.synchronize()
        return eng, outs, time.perf_counter() - t0

    # a first pass of flat, untimed and uncounted, under the Recorder: it
    # keeps the inputs of each distinct kernel shape for phase 8 (the
    # timed pass below runs the same prompts on the same weights), and it
    # warms cuBLAS and the allocator for the timed pass.  auto's 256
    # host-dispatched decode-extend steps take 9-45 s a pass, so auto is
    # not warmed but timed once (the time budget's cut, PERF.md §4),
    # under the Recorder, which copies the inputs of its one new shape
    # (the batch-1 molecule prefill, a few MB) and counts nothing
    rec = Recorder()
    t0 = time.perf_counter()
    with rec:
        serve("flat")
    log(f"lm {cfg.name} warm-up pass (flat, recorded): "
        f"{time.perf_counter() - t0:.1f} s")

    reset_launches()
    results = {}
    for policy in ("flat", "auto"):
        with rec if policy == "auto" else contextlib.nullcontext():
            eng, outs, secs = serve(policy)
        peak = torch.cuda.max_memory_allocated(dev)
        st = eng.stats
        plan = eng.last_plan
        assert sorted(outs) == list(range(LM_REQUESTS))
        assert all(len(v) == LM_NEW for v in outs.values()), \
            f"{policy}: not every request got {LM_NEW} tokens"
        assert bool(torch.isfinite(eng.logits).all()), \
            f"{policy}: non-finite logits"
        extra = ""
        if plan is not None and n_attn:
            assert plan.shares and plan.molecule_tokens.shape == \
                (1, LM_SHARED), (plan.depth_chunks,
                                 plan.molecule_tokens.shape)
            extra = (f", molecules {plan.molecule_tokens.shape[0]} x "
                     f"{plan.molecule_tokens.shape[1]} tokens, kv "
                     f"savings {plan.savings_pct:.1f}%, molecule "
                     f"prefill {st['molecule_prefill_s']:.4f} s + "
                     f"{length - plan.suffix_start} decode-extend steps")
        elif plan is not None:
            # no KV bytes (an attention-free stack): nothing to share
            assert not plan.shares and eng._kv_bytes_per_token() == 0, plan
            extra = ", no sharing planned (0 KV bytes per token)"
        log(f"lm serve {cfg.name} {policy} (warm): {LM_REQUESTS} requests "
            f"x {length} prompt tokens -> {LM_NEW} new each in {secs:.4f} "
            f"s: prompt phase {st['prefill_s']:.4f} s{extra}, mean decode "
            f"step {1e3 * sum(st['decode_s']) / len(st['decode_s']):.3f} ms "
            f"over {len(st['decode_s'])} steps, peak device memory "
            f"{peak / 2**30:.2f} GiB")
        results[policy] = (outs, eng.logits, st["prefill_s"], plan)
    log(f"lm {cfg.name} prompt phase auto / flat: "
        f"{results['auto'][2] / results['flat'][2]:.2f}")
    launched = read_launches(("flash_attention", "linear_scan"))
    kinds = flash_kernel_launches()
    # per timed pass: one prefill per policy (auto's is its molecule's);
    # the scan also runs in every RG-LRU decode step, auto's
    # decode-extend steps among them
    shares = results["auto"][3].shares
    want = {"flash_attention": 2 * n_attn,
            "linear_scan": 2 * n_ssd + n_rglru * (
                2 + 2 * (LM_NEW - 1) + (LM_OWN if shares else 0))}
    assert launched == want, f"{cfg.name} launched {launched}, not {want}"
    assert kinds == {"tensor_core": launched["flash_attention"],
                     "cuda_core": 0}, f"bf16 prefills launched {kinds}"
    flash_d = {key[0][3] for key in rec.flash}
    assert flash_d == ({cfg.resolved_head_dim} if n_attn else set()), \
        flash_d
    # both policies' prefills are held in phase 8: flat's batch and, where
    # auto shares, its batch-1 molecule
    assert {key[0][0] for key in rec.flash} == (
        ({LM_REQUESTS, 1} if shares else {LM_REQUESTS}) if n_attn
        else set()), list(rec.flash)
    if n_ssd:
        ssd_shape = (LM_REQUESTS * cfg.ssm_heads, -(-length // cfg.ssm_chunk),
                     cfg.ssm_state * cfg.ssm_head_dim)
        assert {key[0] for key in rec.scan} == {ssd_shape}, list(rec.scan)
    log(f"lm {cfg.name} launches {launched}, flash kernels {kinds} "
        f"(as counted from the layers: flash {n_attn} per prefill, all "
        f"tensor-core, head size {sorted(flash_d)}; scan {n_ssd} SSD per "
        f"prefill at {sorted(k[0] for k in rec.scan)}, {n_rglru} RG-LRU "
        "per prefill and per decode step)")

    (f_out, f_lg, _, _), (a_out, a_lg, _, _) = (results["flat"],
                                                results["auto"])
    delta = float((f_lg[0] - a_lg[0]).abs().max())
    scale = float(f_lg[0].abs().max())
    tol = bf16_steps(scale, LM_LOGIT_STEPS)
    same = sum(x == y for r in range(LM_REQUESTS)
               for x, y in zip(f_out[r], a_out[r]))
    first = sum(f_out[r][0] == a_out[r][0] for r in range(LM_REQUESTS))
    log(f"lm {cfg.name} flat vs auto: next-token logits max |delta| "
        f"{delta:.4g} (logit scale {scale:.4g}, tolerance {tol:.4g} = "
        f"{LM_LOGIT_STEPS} bf16 steps); first tokens "
        f"agree {first}/{LM_REQUESTS}; generated tokens agree "
        f"{same}/{LM_REQUESTS * LM_NEW} = {same / (LM_REQUESTS * LM_NEW):.3f}")
    assert delta <= tol, \
        f"flat and auto next-token logits differ by {delta}"
    if not shares:
        # without a molecule auto runs flat's path: the same tokens
        assert a_out == f_out and torch.equal(a_lg, f_lg), \
            "auto without sharing departs from flat"

    # where the time goes: one traced flat prefill and four decode steps
    # (after the counts were read, so their launches count nowhere)
    eng = Engine(model, cache_len=cache_len, chunk=LM_CHUNK,
                 policy="flat", device=dev)
    toks = torch.as_tensor(np.stack(prompts), dtype=torch.int64,
                           device=dev)
    state = {}

    def prefill():
        state["out"] = eng._prefill(toks)

    def decode():
        cur, cache, _ = state["out"]
        for t in range(4):
            pos = torch.full((LM_REQUESTS, 1), length + t,
                             dtype=torch.int32, device=dev)
            cur, cache, _ = eng._decode(cur[:, None], cache, pos)

    profile_window(f"{cfg.name} flat prefill ({LM_REQUESTS} x {length})",
                   prefill)
    profile_window(f"{cfg.name} 4 decode steps at batch {LM_REQUESTS}",
                   decode)
    return launched, rec


def lm_policy_parity_f32(dev, arch: str) -> dict[str, int]:
    """Phase 7b: ``flat`` against ``auto`` in float32 on the card, through
    the kernels ``arch``'s layers run (the reduced config at head_dim 64,
    4 prompts of 48 tokens sharing 40, past recurrentgemma's window of 32
    with a wrap): equal tokens and logits within ``LM_F32_TOL``, flash
    only as its CUDA-core kernel.  On a stack with recurrent layers a
    second decode of the last prompt token must break that limit (RG-LRU
    tenfold, SSD threefold), so the check can see it (on an
    attention-only stack it rewrites the same k/v in the same slot).  Returns the two flash
    kernels' launches of the two runs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import LM
    from repro_torch.serving import Engine, Request

    cfg = reduced(get_arch(arch), head_dim=64)
    has_kv = any(k in ("attn", "local") for k in cfg.pattern)
    recurrent = any(k in ("rglru", "ssd") for k in cfg.pattern)
    model = LM(cfg, device=dev,
               generator=torch.Generator(device=dev).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    n, length, shared, new = 4, 48, 40, 6
    system = rng.integers(1, cfg.vocab_size, shared, dtype=np.int32)
    toks = np.stack([np.concatenate([system, rng.integers(
        1, cfg.vocab_size, length - shared, dtype=np.int32)])
        for _ in range(n)])
    res = {}
    reset_launches()
    with Recorder() as rec:
        for policy in ("flat", "auto"):
            eng = Engine(model, cache_len=length + new, chunk=8,
                         policy=policy, device=dev)
            for i, p in enumerate(toks):
                eng.submit(Request(rid=i, tokens=p, max_new=new))
            res[policy] = (eng.run(keep_logits=True), eng.logits)
    kinds = flash_kernel_launches()
    scans = read_launches(("linear_scan",))["linear_scan"]
    assert kinds["tensor_core"] == 0 and (kinds["cuda_core"] > 0) == has_kv, \
        f"float32 prefills launched {kinds}"
    assert (scans > 0) == recurrent, f"{cfg.name}: {scans} scan launches"
    (f_out, f_lg), (a_out, a_lg) = res["flat"], res["auto"]
    plan = eng.last_plan
    if has_kv:
        assert plan.shares and plan.suffix_start == shared, plan.suffix_start
    else:
        assert not plan.shares, plan
    delta = float((f_lg - a_lg).abs().max())
    # the JAX engine's fault 2: decode the last prompt token once more
    _, cache, _ = eng._prefill_shared(toks, plan)
    pos = torch.full((n, 1), length - 1, dtype=torch.int32, device=dev)
    _, _, twice = eng._decode(torch.as_tensor(
        toks[:, -1:], dtype=torch.int64, device=dev), cache, pos)
    fault = float((twice - f_lg[0]).abs().max())
    log(f"lm {cfg.name} float32 flat vs auto on the card ({lm_layers(cfg)}"
        f", d {cfg.d_model}, head_dim 64, window {cfg.window}, {n} x "
        f"{length} tokens, {new} new, sharing {plan.shares}): tokens equal "
        f"{a_out == f_out}, logits max |delta| {delta:.4g} (logit scale "
        f"{float(f_lg.abs().max()):.4g}, tolerance {LM_F32_TOL}); a second "
        f"decode of the last prompt token would move them {fault:.4g}; "
        f"flash kernels {kinds}, scan {scans}")
    assert a_out == f_out, "float32 flat and auto tokens differ"
    assert delta <= LM_F32_TOL, f"float32 flat/auto logits differ by {delta}"
    if recurrent:
        # a second RG-LRU step moves the reduced model's logits by ~4e-4,
        # a second SSD step by ~5e-5 (float32, on the CPU as on the card)
        margin = 10 if "rglru" in cfg.pattern else 3
        assert fault > margin * LM_F32_TOL, \
            "the check cannot see a double decode"
    # the float32 kernels against their plain versions on the inputs
    # this path gave them (after the counts were read)
    for q, k, v, kw in rec.flash.values():
        flash_case(q, k, v, kw, f"float32 path q {tuple(q.shape)} kv "
                                f"{tuple(k.shape)} {kw}")
    for x, a, h0 in rec.scan.values():
        scan_case(x, a, h0, f"float32 path x {tuple(x.shape)} "
                            f"h0={h0 is not None}")
    return kinds


# ---------------------------------------------------------------------------
# phases 7e-7f: the frontend stubs through serve_step, and every config
# ---------------------------------------------------------------------------

def stub_inputs(cfg, batch: int, text: int, dev, shared: int = 0):
    """Seeded frontend embeddings (whisper's frames, the VLM's patches)
    and text tokens for ``cfg``, the first ``shared`` of them the same in
    every request (phase 7's system prompt).  Returns (tokens,
    embeddings, the position of the first token after the text)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy(rng.standard_normal(
        (batch, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model)
    ).astype(np.float32)).to(dev)
    system = rng.integers(1, cfg.vocab_size, shared)
    toks = np.stack([np.concatenate([system, rng.integers(
        1, cfg.vocab_size, text - shared)]) for _ in range(batch)])
    offset = cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0
    return (torch.as_tensor(toks, dtype=torch.int64, device=dev), frames,
            offset + text)


def next_token_check(model, toks, frames, start: int, dev):
    """The logits of a prefill of T - 1 tokens and one decode step of
    the T-th, and those of a prefill of all T: (decode, prefill)."""
    import torch
    from repro_torch.train.serve_step import make_decode_step, \
        make_prefill_step

    prefill = make_prefill_step(model, cache_len=start + 1)
    _, cache, _ = prefill(toks[:, :-1], frames)
    pos = torch.full((toks.shape[0], 1), start - 1, dtype=torch.int32,
                     device=dev)
    _, _, dec = make_decode_step(model)(toks[:, -1:], cache, pos)
    _, _, full = prefill(toks, frames)
    return dec, full


def stub_serve(dev, arch: str):
    """Phase 7e: ``arch`` (whisper-medium or internvl2-2b) at full width
    through ``serve_step`` with its frontend embeddings: a prefill of
    the batch and LM_NEW - 1 greedy decode steps, timed after an
    untimed pass (recorded for phase 8); flash launched only as its
    bf16 kernel, as many times as the layers call it (whisper: encoder,
    self- and cross-attention in prefill, cross-attention at T = 1 in
    every decode step), every logit finite, and a prefill of T - 1
    tokens plus one decode step within LM_LOGIT_STEPS of a prefill of
    T.  Returns (launch counts of the timed pass, the recorder)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import frontend_generate
    from repro_torch.train.serve_step import make_decode_step, \
        make_prefill_step

    cfg = get_arch(arch)
    model = build_lm(cfg, dev)
    text, shared = ((WHISPER_PROMPT, 0) if cfg.encoder_layers else
                    (LM_SHARED + LM_OWN, LM_SHARED))
    toks, frames, start = stub_inputs(cfg, LM_REQUESTS, text, dev, shared)
    b = LM_REQUESTS

    def serve():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        return frontend_generate(model, toks, frames, LM_NEW)

    with Recorder() as rec:
        serve()
    reset_launches()
    st = serve()
    launched = read_launches(("flash_attention", "linear_scan"))
    kinds = flash_kernel_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    logits = torch.stack(st.pop("logits"))
    assert bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits"
    xattn = cfg.n_layers if cfg.encoder_layers else 0
    want = cfg.n_layers + cfg.encoder_layers + xattn + (LM_NEW - 1) * xattn
    assert launched == {"flash_attention": want, "linear_scan": 0}, \
        f"{arch} launched {launched}, not {want} flash"
    assert kinds == {"tensor_core": want, "cuda_core": 0}, kinds
    flash_d = {key[0][3] for key in rec.flash}
    assert flash_d == {cfg.resolved_head_dim}, flash_d
    if cfg.encoder_layers:
        enc = st["cache"][0]["xattn"]["k"]
        assert tuple(enc.shape) == (b, cfg.n_kv_heads, cfg.frontend_tokens,
                                    cfg.resolved_head_dim), enc.shape
    del st["cache"]
    log(f"lm serve_step {cfg.name} (warm): {b} requests x {text} prompt "
        f"tokens + {cfg.frontend_tokens} {cfg.frontend} embeddings -> "
        f"{LM_NEW} new each: prompt phase {st['prefill_s']:.4f} s, mean "
        f"decode step {1e3 * sum(st['decode_s']) / len(st['decode_s']):.3f}"
        f" ms over {len(st['decode_s'])} steps, peak device memory "
        f"{peak / 2**30:.2f} GiB; flash {launched['flash_attention']} "
        f"(tensor-core, head size {sorted(flash_d)}, shapes "
        f"{[(k[0], k[1]) for k in rec.flash]})")

    dec, full = next_token_check(model, toks, frames, start, dev)
    delta = float((dec - full).abs().max())
    scale = float(full.abs().max())
    tol = bf16_steps(scale, LM_LOGIT_STEPS)
    log(f"lm {cfg.name} prefill of {text - 1} + one decode step vs prefill "
        f"of {text}: logits max |delta| {delta:.4g} (scale {scale:.4g}, "
        f"tolerance {tol:.4g} = {LM_LOGIT_STEPS} bf16 steps), next tokens "
        f"agree {int((dec.argmax(-1) == full.argmax(-1)).sum())}/{b}")
    assert bool(torch.isfinite(dec).all() and torch.isfinite(full).all())
    assert delta <= tol, f"{arch}: decode and prefill differ by {delta}"

    # where the time goes: one traced prefill and four decode steps
    prefill = make_prefill_step(model, cache_len=start + LM_NEW)
    decode = make_decode_step(model)
    state = {}

    def prefill_only():
        state["out"] = prefill(toks, frames)

    def decode4():
        cur, cache, _ = state["out"]
        for t in range(4):
            pos = torch.full((b, 1), start + t, dtype=torch.int32,
                             device=dev)
            cur, cache, _ = decode(cur[:, None], cache, pos)

    profile_window(f"{cfg.name} prefill ({b} x {text} + "
                   f"{cfg.frontend_tokens})", prefill_only)
    profile_window(f"{cfg.name} 4 decode steps at batch {b}", decode4)
    return launched, rec


def stub_parity_f32(dev, arch: str) -> dict[str, int]:
    """Phase 7e in float32: the reduced config of ``arch`` at head_dim 64
    on the card, a prefill of 39 tokens plus one decode step against a
    prefill of 40 within LM_F32_TOL, flash only as its CUDA-core kernel,
    held against its plain version on the inputs this path gave it.
    Returns the flash kernels' launches."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import LM

    cfg = reduced(get_arch(arch), head_dim=64)
    model = LM(cfg, device=dev,
               generator=torch.Generator(device=dev).manual_seed(SEED))
    toks, frames, start = stub_inputs(cfg, 4, 40, dev)
    reset_launches()
    with Recorder() as rec:
        dec, full = next_token_check(model, toks, frames, start, dev)
    kinds = flash_kernel_launches()
    delta = float((dec - full).abs().max())
    log(f"lm {cfg.name} float32 on the card ({cfg.n_layers} layers, "
        f"encoder {cfg.encoder_layers}, d {cfg.d_model}, head_dim 64): "
        f"prefill of 39 + one decode step vs prefill of 40, logits max "
        f"|delta| {delta:.4g} (scale {float(full.abs().max()):.4g}, "
        f"tolerance {LM_F32_TOL}); flash kernels {kinds}")
    assert kinds["tensor_core"] == 0 and kinds["cuda_core"] > 0, kinds
    assert delta <= LM_F32_TOL, f"{arch} float32: {delta}"
    for q, k, v, kw in rec.flash.values():
        flash_case(q, k, v, kw, f"float32 path q {tuple(q.shape)} kv "
                                f"{tuple(k.shape)} {kw}")
    return kinds


def arch_sweep(dev) -> tuple[dict[str, int], dict]:
    """Phase 7f: every config of ``ARCHS`` at its published width, depth
    cut to SWEEP_LAYERS (and SWEEP_LAYERS encoder layers), bf16: a
    SWEEP_TOKENS-token prefill (after the VLM's patches, over whisper's
    frames) and one decode step at batch 1, every logit finite, flash
    launched (bf16 only) at the config's head size by every attention
    layer, the scan by every recurrent one.  Returns the launch counts
    summed over the configs and each config's recorder, for phase 8."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.train.serve_step import make_decode_step, \
        make_prefill_step

    totals = {"flash_attention": 0, "linear_scan": 0}
    recs = {}
    for name, full in ARCHS.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(
            full, n_layers=max(SWEEP_LAYERS, len(full.layer_pattern)),
            encoder_layers=min(full.encoder_layers, SWEEP_LAYERS))
        model = build_lm(cfg, dev)
        toks, frames, start = stub_inputs(cfg, 1, SWEEP_TOKENS, dev)
        frames = frames if cfg.frontend != "none" else None
        reset_launches()
        with Recorder() as rec:
            nxt, cache, first = make_prefill_step(
                model, cache_len=start + 1)(toks, frames)
            pos = torch.full((1, 1), start, dtype=torch.int32, device=dev)
            _, _, second = make_decode_step(model)(nxt[:, None], cache, pos)
        torch.cuda.synchronize()
        launched = read_launches(("flash_attention", "linear_scan"))
        kinds = flash_kernel_launches()
        n_attn = sum(k in ("attn", "local") for k in cfg.pattern)
        n_rec = sum(k in ("rglru", "ssd") for k in cfg.pattern)
        flash_d = {key[0][3] for key in rec.flash}
        log(f"lm sweep {name}: {lm_layers(cfg)} layers, encoder "
            f"{cfg.encoder_layers}, {SWEEP_TOKENS} tokens + one decode step"
            f": launches {launched}, flash head sizes {sorted(flash_d)}, "
            f"logit scale {float(first.abs().max()):.4g} / "
            f"{float(second.abs().max()):.4g}, peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
            f"{time.perf_counter() - t0:.1f} s")
        assert bool(torch.isfinite(first).all() and
                    torch.isfinite(second).all()), f"{name}: non-finite"
        assert flash_d == ({cfg.resolved_head_dim} if n_attn else set()), \
            (name, flash_d)
        assert kinds["cuda_core"] == 0 and \
            (launched["flash_attention"] > 0) == bool(n_attn), (name, kinds)
        assert (launched["linear_scan"] > 0) == bool(n_rec), (name, launched)
        for k in totals:
            totals[k] += launched[k]
        recs[f"{name} (sweep)"] = rec
        del model, cache
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return totals, recs


# ---------------------------------------------------------------------------
# phase 8: the LM kernels on the path's own inputs, and their times
# ---------------------------------------------------------------------------

def flash_times(q, k, v, kw: dict) -> dict:
    """The flash kernel that ``q``'s type routes to, its plain version and
    SDPA (boolean mask, KV head expanded) on the same inputs; the bound
    counts the attended pairs at the type's peak rate (bf16 tensor cores
    or float32 CUDA cores)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     kernel_for)

    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    mask = ref.attention_mask(t, s, kw.get("causal", True), kw.get("window"),
                              q.device)
    pairs = int(mask.sum())                       # attended (q, k) per head
    flops = 4 * d * hq * b * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    peak = BF16_TENSOR_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    kx = k.repeat_interleave(hq // hkv, dim=1)
    vx = v.repeat_interleave(hq // hkv, dim=1)
    rec = dict(
        name=f"flash_attention ({kernel_for(q.dtype, d)})",
        shape=f"q {tuple(q.shape)} kv {tuple(k.shape)} {q.dtype} {kw}, "
              f"{pairs} attended pairs per head",
        ms=time_ms(lambda: flash_attention(q, k, v, **kw), 10, 2),
        plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, **kw), 3, 1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=mask), 10, 2),
        bound=(nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3))
    del kx, vx, mask
    return with_bound(rec)


def scan_times(x, a, h0) -> dict:
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_plain

    sb, _, sd = x.shape
    scan_bytes = 3 * x.numel() * x.element_size() + 4 * sb * sd * (
        2 if h0 is not None else 1)
    return with_bound(dict(
        name="linear_scan",
        shape=f"x, a {tuple(x.shape)} {x.dtype}, h0 {h0 is not None}",
        ms=time_ms(lambda: linear_scan(x, a, h0), 50, 5),
        plain_ms=time_ms(lambda: linear_scan_plain(x, a, h0), 3, 1),
        library_ms=None,
        bound=(scan_bytes / HBM_BYTES_PER_S * 1e3,
               2 * x.numel() / F32_FLOPS * 1e3)))


def lm_path_parity_and_times(recs: dict) -> dict:
    """Phase 8, over the recorders of phases 7 and 7c-7f (by architecture;
    7f's at every config's head size and GQA group).  Returns the
    record fields of both LM kernels at their largest recorded shape."""
    import torch

    for arch, rec in recs.items():
        for q, k, v, kw in rec.flash.values():
            flash_case(q, k, v, kw, f"{arch} path q {tuple(q.shape)} kv "
                                    f"{tuple(k.shape)} {q.dtype} {kw}",
                       control=True)
        for x, a, h0 in rec.scan.values():
            scan_case(x, a, h0, f"{arch} path x {tuple(x.shape)} {x.dtype} "
                                f"h0={h0 is not None}")
        log(f"lm main-path parity, {arch}: flash q/kv shapes "
            f"{[(k[0], k[1]) for k in rec.flash]}, scan shapes "
            f"{[(k[0], 'no h0' if k[2] else 'h0') for k in rec.scan]}")
    log(f"lm main-path parity: max |delta| flash bf16 "
        f"{ERR['flash_attention']:.3g}, float32 "
        f"{ERR['flash_attention_f32']:.3g}, scan {ERR['linear_scan']:.3g}")

    # every recorded shape (the flash prefills; the scan's prefills and
    # its decode step), largest first: the largest one's numbers go into
    # the record
    by_size = lambda r: -r[0].numel()                          # noqa: E731
    flash_in = [r for rec in recs.values() for r in rec.flash.values()]
    scan_in = [r for rec in recs.values() for r in rec.scan.values()]
    flash = [flash_times(*r) for r in sorted(flash_in, key=by_size)]
    scan = [scan_times(*r) for r in sorted(scan_in, key=by_size)]

    # the float32 CUDA-core kernel at the largest prefill shape, on the
    # same inputs in float32, beside the tensor-core kernel and SDPA above
    q, k, v, kw = max(flash_in, key=lambda r: r[0].numel())
    q, k, v = q.float(), k.float(), v.float()
    flash_case(q, k, v, kw, f"path q {tuple(q.shape)} kv {tuple(k.shape)} "
                            f"as float32 {kw}")
    f32 = flash_times(q, k, v, kw)
    del q, k, v
    torch.cuda.empty_cache()
    return {"flash_attention": flash[0], "flash_attention_f32": f32,
            "linear_scan": scan[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-triples", type=int, default=10_000_000)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    # a build dir of its own, emptied first: every run compiles, so the
    # ptxas lines below are always read
    build.BUILD_DIR = ROOT / "build" / "chip_smoke_kernels"
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"kernels built from {build.CSRC.relative_to(ROOT)} "
        f"({', '.join(build.SOURCES)}) -> {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    kernel, seen = "", set()
    for line in build.BUILD_LOG.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            kernel = kernel_name(m.group(1))
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {kernel}: {line.strip()}")
            assert "spill" not in line or \
                "0 bytes spill stores, 0 bytes spill loads" in line, \
                f"{kernel} spills registers"
            seen.add(kernel.split("I")[0])
    assert seen == {"sig_hash_kernel", "seg_count_kernel", "flash_fwd_kernel",
                    "flash_sm90_kernel", "linear_scan_kernel"}, seen

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
    # phases 3-4 record the kernels' inputs for phase 5
    with KernelInputs() as main_inputs:
        runs = compaction(store, totals)
        gd_comp = check_compaction(store, runs)

        # phase 4
        queries, answers = star_queries(store, gd_comp.fgraph, totals)

    # phase 4b
    t0 = time.perf_counter()
    cfg = compressed_tier(store, runs, queries, answers, totals)
    log(f"compressed-tier phase: {time.perf_counter() - t0:.1f} s")

    # phase 4c
    t0 = time.perf_counter()
    with_parity("gspan phase", dev, gspan_baseline, totals)
    log(f"gspan phase: {time.perf_counter() - t0:.1f} s")

    # phase 4d
    snap = gd_comp.snapshot
    t0 = time.perf_counter()
    with_parity("mutation phase", dev, mutations, store, runs, cfg, totals)
    del cfg
    log(f"mutation phase: {time.perf_counter() - t0:.1f} s")

    # phase 4e
    t0 = time.perf_counter()
    with_parity("online phase", dev, durable_online, store, snap,
                gd_comp.backend, queries, totals)
    del snap
    log(f"online phase: {time.perf_counter() - t0:.1f} s")

    # phase 4f
    t0 = time.perf_counter()
    with_parity("crash sweep phase", dev, crash_sweep, gd_comp.backend,
                totals)
    log(f"crash sweep phase: {time.perf_counter() - t0:.1f} s")

    # phase 4g
    t0 = time.perf_counter()
    auto_wave = with_parity("bgp and graph server phase", dev,
                            bgp_and_graph_server, store, gd_comp.snapshot,
                            totals)
    log(f"bgp and graph server phase: {time.perf_counter() - t0:.1f} s")

    # phase 4h
    t0 = time.perf_counter()
    with_parity("sharded phase", dev, sharded, store, runs,
                gd_comp.snapshot, auto_wave, dev, totals)
    del auto_wave
    log(f"sharded phase: {time.perf_counter() - t0:.1f} s")

    # phase 5
    log(f"main-path parity: {main_inputs.check(dev)}, all bit-exact")
    times = kernel_times(*main_inputs.widest_sweep(dev))
    del store, runs, gd_comp, main_inputs
    torch.cuda.empty_cache()

    # phase 6
    t0 = time.perf_counter()
    lm_kernel_parity(dev)
    log(f"lm kernel parity phase: {time.perf_counter() - t0:.1f} s")

    # phases 7 (the hybrid stack), 7c (the dense and the SSM stack), 7d
    # (MoE) and 7b (each in float32, reduced), 7e (the frontend stubs
    # through serve_step, and in float32) and 7f (every config, 2
    # layers): each path's counts start at 0 and are summed in after it
    totals.update(flash_attention=0, linear_scan=0, flash_attention_f32=0)
    recs = {}
    for arch in LM_ARCHS + STUB_ARCHS:
        t0 = time.perf_counter()
        serve, parity = ((lm_serve, lm_policy_parity_f32)
                         if arch in LM_ARCHS else
                         (stub_serve, stub_parity_f32))
        lm_launches, recs[arch] = serve(dev, arch)
        for name, n in lm_launches.items():
            totals[name] += n
        torch.cuda.empty_cache()
        # the float32 serve path is the float32 kernel's own path
        totals["flash_attention_f32"] += parity(dev, arch)["cuda_core"]
        torch.cuda.empty_cache()
        log(f"lm serve phase, {arch}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sweep_launches, sweep_recs = arch_sweep(dev)
    for name, n in sweep_launches.items():
        totals[name] += n
    recs.update(sweep_recs)
    del sweep_recs
    log(f"lm sweep phase (every config, {SWEEP_LAYERS} layers): "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 8
    t0 = time.perf_counter()
    times.update(lm_path_parity_and_times(recs))
    del recs
    log(f"lm path parity and timing phase: {time.perf_counter() - t0:.1f} s")

    # the bf16 serve path launches flash_attention as its tensor-core
    # kernel, the float32 one as its CUDA-core kernel
    src = "src/repro_torch/kernels/csrc/"
    source = {"flash_attention": "flash_attention_sm90.cu",
              "flash_attention_f32": "flash_attention.cu"}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": src + source.get(name, f"{name}.cu"),
         "replaces": replaces, "launches": totals[name],
         "max_abs_err": ERR[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"]}
        for name, replaces in (
            ("sig_hash", "src/repro/kernels/sig_hash.py:61"),
            ("seg_count", "src/repro/kernels/seg_count.py:46"),
            ("flash_attention", "src/repro/kernels/flash_attention.py:78"),
            ("flash_attention_f32",
             "src/repro/kernels/flash_attention.py:78"),
            ("linear_scan", "src/repro/kernels/linear_scan.py:49"))]}
    for k in record["kernels"]:
        assert k["launches"] > 0 and k["max_abs_err"] <= LIMIT[k["name"]], k
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
