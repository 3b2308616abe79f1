"""Dry run of every (architecture x input shape x mesh) cell on ``meta``
tensors: the per-device roofline of the port's step on H100 meshes.

The counterpart of ``repro/launch/dryrun.py``.  There, each cell's jitted
train / prefill / decode step is lowered and compiled for 256 or 512
placeholder host devices and its HLO costed.  Here each cell builds the
port's own model and step on the ``meta`` device (nothing is allocated,
no card is opened, nothing falls back to running), lays it out with the
plan ``dist.sharding`` makes for the production mesh
(``launch/mesh.py``: 32 nodes of 8 H100s, or two such pods), runs one
step at the per-device microbatch under ``launch/op_cost.py``'s counting
mode and turns the counts into ``launch/roofline.py``'s terms.  MoE runs
``moe_shard_map`` (static capacities; the ``ragged`` path reads group
sizes on the host, which ``meta`` tensors do not have), and decode over
a sequence-sharded cache ``decode_attention_sharded``, as the JAX dry run
does.

    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both      # 80 cells
    python -m repro_torch.launch.dryrun --all --mesh both --jobs 4
    python -m repro_torch.launch.dryrun --list --mesh both
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
        --mesh 1x1 --batch 8      # one device at the global batch 8

Each cell writes one JSON (``status``: ``ok``, ``skip`` from
``configs.applicable`` or ``error``; ``fallbacks``; ``roofline`` with
``memory_analysis.peak_bytes``; the per-device ``counts``) into
``--out`` (default ``experiments/dryrun_torch``, git-ignored);
``launch/report.py`` tabulates them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import torch

from ..configs import ARCHS, SHAPES, applicable, get_arch
from ..dist import sharding as sh
from ..dist.mesh import make_mesh
from ..models.common import torch_dtype
from . import op_cost
from . import roofline as rl
from .mesh import make_production_mesh

OUT_DIR = str(Path(__file__).resolve().parents[3] / "experiments"
              / "dryrun_torch")
MESH_KINDS = ("single", "multi", "1x1")
META = torch.device("meta")


def make_cell_mesh(mesh_kind: str):
    """The mesh of ``--mesh``: the 256-GPU production mesh, the 512-GPU
    two-pod one, or one device (``1x1``), all of ``meta`` entries."""
    if mesh_kind == "1x1":
        return make_mesh((1, 1), ("data", "model"), META)
    if mesh_kind not in ("single", "multi"):
        raise ValueError(f"unknown mesh {mesh_kind!r}; one of {MESH_KINDS}")
    return make_production_mesh(multi_pod=mesh_kind == "multi")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(arch: str, shape: str = "train_4k", *,
                batch: int | None = None) -> dict:
    """``meta`` stand-ins for every input of one cell's step at the
    shape's global batch (or ``batch``): train {tokens, labels[,
    frontend]}, prefill {tokens[, frontend]}, decode {tokens, positions,
    cache}."""
    sp = SHAPES[shape]
    return _inputs_of(get_arch(arch), sp,
                      sp.global_batch if batch is None else batch)


def _inputs_of(cfg, sp, b: int) -> dict:
    out: dict = {"tokens": _meta((b, 1 if sp.kind == "decode" else
                                  sp.seq_len), torch.int32)}
    if sp.kind == "train":
        out["labels"] = _meta((b, sp.seq_len), torch.int32)
    if sp.kind == "decode":
        out["positions"] = _meta((b, 1), torch.int32)
        out["cache"] = _cache(cfg, b, sp.seq_len)
    elif cfg.frontend != "none":
        fd = cfg.frontend_dim or cfg.d_model
        out["frontend"] = _meta((b, cfg.frontend_tokens, fd),
                                torch_dtype(cfg.dtype))
    return out


def _cache_specs(cfg, batch: int, cache_len: int) -> list:
    from ..models import lm
    return [lm._layer_cache_specs(cfg, k, batch, cache_len)
            for k in cfg.pattern]


def _cache(cfg, batch: int, cache_len: int) -> list:
    return sh._map_specs(lambda s: _meta(s.shape, torch_dtype(s.dtype)),
                         _cache_specs(cfg, batch, cache_len))


def _walk(specs, tensors):
    """(TSpec, tensor) pairs of two trees of the same structure."""
    if isinstance(specs, dict):
        for k in specs:
            yield from _walk(specs[k], tensors[k])
    elif isinstance(specs, (list, tuple)):
        for s, t in zip(specs, tensors):
            yield from _walk(s, t)
    else:
        yield specs, tensors


@dataclasses.dataclass
class Cell:
    """One cell, built and ready to count: ``step(*args, on_grads)``."""
    cfg: object
    shape: object
    mesh: object
    plan: sh.Plan
    micro: int                   # the global microbatch
    b_dev: int                   # the per-device microbatch
    batch_axes: tuple
    attribution: op_cost.Attribution
    decode_sharded: bool
    step: object
    args: tuple
    live: list
    storage_div: dict
    accum_bytes: float
    param_bytes_tp: float
    param_bytes_fsdp: float


def build_cell(arch: str, shape: str, *, mesh_kind: str = "single",
               overrides: dict | None = None, batch: int | None = None,
               mesh=None) -> Cell:
    """Build one cell on ``meta``: the plan, the model, the step and its
    per-device inputs.  ``batch`` overrides the shape's global batch,
    ``mesh`` (any mesh-like object over ``pod``/``data``/``model``) the
    mesh of ``mesh_kind``."""
    from ..models import lm as lm_mod
    from ..models.lm import LM
    from ..train import make_optimizer, make_train_step
    from ..train.serve_step import make_decode_step, make_prefill_step
    from ..train.train_step import init_train_state

    cfg = get_arch(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    sp = SHAPES[shape]
    if batch is not None:
        sp = dataclasses.replace(sp, global_batch=batch)
    ok, reason = applicable(cfg, sp)
    if not ok:
        raise ValueError(reason)
    mesh = make_cell_mesh(mesh_kind) if mesh is None else mesh
    plan = sh.make_plan(cfg, mesh)
    train, decode = sp.kind == "train", sp.kind == "decode"
    accum = cfg.grad_accum if train else 1
    micro = max(sp.global_batch // accum, 1)

    # the JAX build_cell's layout decisions (their fallbacks are recorded)
    sh.act_spec(plan, micro, decode=decode, seq=sp.seq_len)
    sh.qkv_specs(plan, cfg, micro, seq=sp.seq_len)
    param_specs = LM.param_specs(cfg)
    sh.tree_shardings(plan, param_specs)
    sh.layer_compute_specs(plan, [lm_mod._layer_specs(cfg, k)
                                  for k in cfg.pattern])
    axes = sh.batch_axes_for(plan, micro)
    b_dev = micro // math.prod(plan.size(a) for a in axes)

    # sequence-sharded decode cache -> decode_attention_sharded
    decode_specs = None
    if decode and cfg.n_kv_heads:
        from ..models.blocks import attn_cache_specs
        window = cfg.window if "local" in cfg.pattern else None
        kspec = sh.spec_for(plan, attn_cache_specs(
            cfg, sp.global_batch, sp.seq_len, cfg.dtype, window=window)["k"])
        if len(kspec) > 2 and kspec[2] == "model":
            decode_specs = (sh.P(None, None, None, None),
                            sh.P(None, None, "model", None),
                            sh.P(None, "model"))
    att = op_cost.Attribution.of(plan, cfg, micro=micro, seq=sp.seq_len,
                                 kind=sp.kind,
                                 decode_sharded=decode_specs is not None)
    # one device's share of the model axis: the per-device batch on every
    # entry of it (MoE's experts, the decode cache's sequence), where the
    # plan shards them over "model"
    split = decode_specs is not None or (
        att.block.get("moe", 1) > 1 and cfg.n_experts % plan.size("model")
        == 0)
    local = make_mesh((1, plan.size("model") if split else 1),
                      ("data", "model"), META)
    model = LM(cfg, device=META,
               moe_impl="shard_map" if cfg.n_experts else "ragged",
               mesh=local, decode_kv_specs=decode_specs)

    def shards(spec, skip=()):
        return op_cost.shard_count(plan, spec, skip)

    live, storage_div = [], {}
    tp_bytes = fsdp_bytes = accum_bytes = 0.0
    accum_item = torch_dtype(cfg.param_dtype).itemsize if cfg.fsdp else 4
    for name, p in model.named_parameters():
        spec = sh.spec_for(plan, param_specs[name])
        n = shards(spec)
        live.append((p, n))
        storage_div.setdefault(tuple(p.shape), n)
        model_only = shards(tuple(e if e == "model" else None
                                  for e in spec))
        tp_bytes += p.numel() * p.element_size() / model_only
        if any(e == "data" for e in spec):
            fsdp_bytes += p.numel() * p.element_size() / model_only
        accum_bytes += p.numel() * accum_item / n

    ins = _inputs_of(cfg, sp, b_dev)
    batch_tensors = [t for k, t in ins.items() if k != "cache"]
    live += [(t, 1) for t in batch_tensors]

    if train:
        opt = make_optimizer(cfg)
        state = init_train_state(model, opt)
        opt_specs = sh.opt_state_specs(cfg, param_specs)
        for s, t in _walk(opt_specs, state.opt):
            n = shards(sh.spec_for(plan, s))
            live.append((t, n))
            storage_div.setdefault(tuple(t.shape), n)
        for s in sh.param_leaf_specs(cfg, param_specs).values():
            storage_div.setdefault(tuple(s.shape),
                                   shards(sh.spec_for(plan, s)))

        def step(state, batch_in, on_grads):
            return make_train_step(model, opt, compress_fn=on_grads)(
                state, batch_in)
        args = (state, ins)
    elif decode:
        cache = ins["cache"]
        specs = _cache_specs(cfg, sp.global_batch, sp.seq_len)
        for s, t in _walk(specs, cache):
            live.append((t, shards(sh.spec_for(plan, s), skip=(0,))))
        dec = make_decode_step(model)

        def step(tokens, cache, positions, on_grads):
            return dec(tokens, cache, positions)
        args = (ins["tokens"], cache, ins["positions"])
    else:
        pf = make_prefill_step(model, cache_len=sp.seq_len)

        def step(tokens, frontend, on_grads):
            return pf(tokens, frontend)
        args = (ins["tokens"], ins.get("frontend"))
    return Cell(cfg=cfg, shape=sp, mesh=mesh, plan=plan, micro=micro,
                b_dev=b_dev, batch_axes=axes, attribution=att,
                decode_sharded=decode_specs is not None, step=step,
                args=args, live=live, storage_div=storage_div,
                accum_bytes=accum_bytes if accum > 1 else 0.0,
                param_bytes_tp=tp_bytes, param_bytes_fsdp=fsdp_bytes)


def count_cell(cell: Cell) -> tuple[op_cost.StepCost, list[dict]]:
    """(the per-device cost of one step of ``cell``, its collectives)."""
    cfg, sp = cell.cfg, cell.shape
    cost, _ = op_cost.count_step(
        cell.step, cell.args, attribution=cell.attribution, live=cell.live,
        storage_div=cell.storage_div,
        grad_accum=cfg.grad_accum if sp.kind == "train" else 1,
        accum_bytes=cell.accum_bytes)
    colls = op_cost.reckon_collectives(
        cell.plan, cfg, cell.attribution, kind=sp.kind, micro=cell.micro,
        b_dev=cell.b_dev, seq=sp.seq_len, param_bytes_tp=cell.param_bytes_tp,
        param_bytes_fsdp=cell.param_bytes_fsdp,
        decode_sharded=cell.decode_sharded)
    return cost, colls


def run_cell(arch: str, shape: str, mesh_kind: str,
             overrides: dict | None = None, tag: str = "",
             batch: int | None = None, mesh=None) -> dict:
    """Build, count and analyze one cell; the record ``report.py``
    reads.  A cell that ``applicable`` rules out is a ``skip``; any
    failure is an ``error`` with its traceback."""
    cfg = get_arch(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    sp = SHAPES[shape]
    if batch is not None:
        sp = dataclasses.replace(sp, global_batch=batch)
    ok, reason = applicable(cfg, sp)
    cell = {"arch": arch, "shape": shape, "mesh": mesh_kind, "tag": tag}
    if batch is not None:
        cell["global_batch"] = batch
    if not ok:
        return {**cell, "status": "skip", "reason": reason}
    t0 = time.perf_counter()
    try:
        c = build_cell(arch, shape, mesh_kind=mesh_kind,
                       overrides=overrides, batch=batch, mesh=mesh)
        cost, colls = count_cell(c)
        counts = cost.to_json()
        mf = rl.model_flops_estimate(cfg, sp.global_batch, sp.seq_len,
                                     sp.kind)
        n_chips = int(c.mesh.devices.size)
        roof = rl.analyze(counts, colls, n_chips=n_chips, model_flops=mf)
        return {**cell, "status": "ok",
                "count_s": round(time.perf_counter() - t0, 2),
                "n_chips": n_chips, "mesh_shape": dict(c.plan.axis_sizes),
                "global_batch": sp.global_batch,
                "grad_accum": cfg.grad_accum if sp.kind == "train" else 1,
                "per_device_batch": c.b_dev,
                "batch_axes": list(c.batch_axes),
                "fallbacks": sorted(set(c.plan.fallbacks)),
                "counts": counts, "roofline": roof.to_json()}
    except Exception as e:  # noqa: BLE001 -- the sweep records bad cells
        return {**cell, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def all_cells(mesh_kinds) -> list[tuple[str, str, str]]:
    return [(arch, shape, mk) for arch in ARCHS for shape in SHAPES
            for mk in mesh_kinds]


def run_cells(cells, jobs: int = 1, overrides: dict | None = None,
              tag: str = "", batch: int | None = None):
    """:func:`run_cell` over ``(arch, shape, mesh_kind)`` triples, in
    ``jobs`` spawned worker processes when ``jobs > 1`` (each cell is
    host work on ``meta`` tensors, independent of the others).  Yields
    each cell's record in the order of ``cells``."""
    if jobs <= 1:
        for arch, shape, mk in cells:
            yield run_cell(arch, shape, mk, overrides, tag, batch)
        return
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as pool:
        futures = [pool.submit(run_cell, arch, shape, mk, overrides, tag,
                               batch) for arch, shape, mk in cells]
        for fut in futures:
            yield fut.result()


def cell_name(arch: str, shape: str, mesh_kind: str, tag: str = "") -> str:
    return f"{arch}__{shape}__{mesh_kind}" + (f"__{tag}" if tag else "")


def write(res: dict, out: str) -> str:
    path = os.path.join(out, cell_name(res["arch"], res["shape"],
                                       res["mesh"], res.get("tag", ""))
                        + ".json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both", "1x1"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--override", default="",
                    help="JSON dict of ArchConfig overrides")
    ap.add_argument("--tag", default="", help="suffix for the output json")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for --all")
    args = ap.parse_args(argv)
    kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.list:
        for arch, shape, mk in all_cells(kinds):
            ok, reason = applicable(get_arch(arch), SHAPES[shape])
            print(f"{arch:24s} {shape:12s} {mk:6s} "
                  f"{'ok' if ok else reason}")
        return 0

    os.makedirs(args.out, exist_ok=True)
    overrides = json.loads(args.override) if args.override else None
    if args.all:
        failures = 0
        for res in run_cells(all_cells(kinds), args.jobs, overrides,
                             args.tag, args.batch):
            write(res, args.out)
            failures += res["status"] not in ("ok", "skip")
            print(f"{res.get('count_s', 0.0):7.2f}s "
                  f"{cell_name(res['arch'], res['shape'], res['mesh'])}: "
                  f"{res['status']}"
                  + (f" ({res['error']})" if res["status"] == "error"
                     else ""), flush=True)
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all, or --list)")
    res = run_cell(args.arch, args.shape, kinds[0], overrides, args.tag,
                   args.batch)
    write(res, args.out)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("roofline", "counts", "traceback")},
                     indent=1))
    r = res.get("roofline", {})
    if r:
        print(f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
              f"collective={r['collective_s']:.4f}s "
              f"bottleneck={r['bottleneck']} "
              f"roofline_fraction={r['roofline_fraction']:.3f}")
        print("mem/device GB:",
              round(r["memory_analysis"]["peak_bytes"] / 2**30, 2))
    return 0 if res.get("status") in ("ok", "skip") else 1


if __name__ == "__main__":
    sys.exit(main())
