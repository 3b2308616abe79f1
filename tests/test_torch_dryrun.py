"""repro_torch's H100 dry run (``launch/{mesh,roofline,op_cost,dryrun,
report}.py``) on the CPU, against the JAX package's where one exists.

The H100 peaks and production meshes; ``model_flops_estimate`` for every
cell and the ring models against JAX's ``collective_stats`` on
hand-written HLO lines (equal); the kernels' own reckoning (``work``)
and their ``meta`` ops; ``op_cost`` at mesh 1x1 against the analytic
2 N tokens plus the flash kernel's operations (within 2%), per-device
counts on a (2, 4) mesh where every dim divides and with ``tp=False``
against the global count (within 1%); ``dryrun --list``'s 80 cells, a
handful of ``run_cell``s at reduced configs, and JAX's
``report.markdown`` printing the port's cells as the port's does.
Nothing here opens a card: every model is built on ``meta``.
"""
import contextlib
import dataclasses
import io
import json
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import linear_scan as ls
from repro_torch.kernels import ref
from repro_torch.launch import dryrun, mesh as lmesh, op_cost, report
from repro_torch.launch import roofline as rl
from repro_torch.models.lm import LM

META = torch.device("meta")


class FakeMesh:
    def __init__(self, shape, names):
        self.devices = np.empty(shape, object)
        self.axis_names = names


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _reduced_overrides(name: str, **extra) -> dict:
    cfg = reduced(get_arch(name))
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if f.name != "name"}
    out.update(extra)
    return out


# ---------------------------------------------------------------------------
# peaks, meshes, roofline
# ---------------------------------------------------------------------------

def test_h100_peaks_and_production_meshes():
    assert (lmesh.PEAK_FLOPS_BF16, lmesh.PEAK_FLOPS_F32, lmesh.HBM_BW,
            lmesh.NVLINK_BW, lmesh.IB_BW) == (989e12, 67e12, 3.35e12,
                                               450e9, 50e9)
    m = lmesh.make_production_mesh()
    assert (m.axis_names, m.devices.shape) == (("data", "model"), (32, 8))
    assert {d.type for d in m.devices.flat} == {"meta"}
    m = lmesh.make_production_mesh(multi_pod=True)
    assert (m.axis_names, m.devices.shape) == (("pod", "data", "model"),
                                               (2, 32, 8))
    assert lmesh.make_test_mesh((2, 2)).devices.shape == (2, 2)
    assert rl.axis_bandwidth("model") == 450e9
    assert rl.axis_bandwidth("pod,data") == rl.axis_bandwidth("data,model") \
        == 50e9


def test_model_flops_estimate_equals_jax(jax):
    from repro.configs import ARCHS as JARCHS
    from repro.launch.roofline import model_flops_estimate as want
    for name in ARCHS:
        for sp in SHAPES.values():
            args = (sp.global_batch, sp.seq_len, sp.kind)
            assert rl.model_flops_estimate(ARCHS[name], *args) == \
                want(JARCHS[name], *args), (name, sp.name)


HLO = """
  %ar = bf16[1024,512]{1,0} all-reduce(bf16[1024,512]{1,0} %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[64,8192]{1,0} all-gather(f32[64,1024]{1,0} %y), replica_groups=[32,8]<=[256], dimensions={1}
  %rs = f32[128,16]{1,0} reduce-scatter(f32[2048,16]{1,0} %z), replica_groups=[16,16]<=[256], dimensions={0}
  %a2a = bf16[16,4096,512]{2,1,0} all-to-all(bf16[16,4096,512]{2,1,0} %w), replica_groups={{0,1,2,3,4,5,6,7}}
  %cp = bf16[8,128]{1,0} collective-permute(bf16[8,128]{1,0} %u), source_target_pairs={{0,1},{1,0}}
  %ars = f32[4096]{0} all-reduce-start(f32[4096]{0} %s), replica_groups={{0,1}}
"""
RING_CASES = (("all-reduce", 1024 * 512 * 2, 4),
              ("all-gather", 64 * 8192 * 4, 8),
              ("reduce-scatter", 128 * 16 * 4, 16),
              ("all-to-all", 16 * 4096 * 512 * 2, 8),
              ("collective-permute", 8 * 128 * 2, 2),
              ("all-reduce", 4096 * 4, 2))


def test_ring_models_equal_jax_collective_stats(jax):
    from repro.launch.roofline import collective_stats
    want = collective_stats(HLO)
    entries = [{"op": op, "bytes": n, "group": g, "axis": "model",
                "count": 1} for op, n, g in RING_CASES]
    got = rl.collective_stats(entries)
    assert got.ops == want.ops
    assert got.by_op == pytest.approx(want.by_op, rel=1e-12)
    assert got.link_bytes == pytest.approx(want.link_bytes, rel=1e-12)
    assert got.result_bytes == want.result_bytes
    for line, (op, n, g) in zip(HLO.strip().splitlines(), RING_CASES):
        assert rl.ring_bytes(op, n, g) == pytest.approx(
            collective_stats(line).link_bytes, rel=1e-12), line


def test_analyze_terms():
    counts = {"flops": 3e12, "flops_by_dtype": {"bfloat16": 2e12,
                                                "float32": 1e12},
              "bytes": 6.7e12, "arg_bytes": 1e9, "peak_bytes": 3e9}
    colls = [{"op": "all-reduce", "bytes": 1e9, "group": 8, "axis": "model",
              "count": 2},
             {"op": "all-gather", "bytes": 4e9, "group": 32, "axis": "data",
              "count": 1}]
    r = rl.analyze(counts, colls, n_chips=256, model_flops=256e12)
    assert r.compute_s == pytest.approx(2e12 / 989e12 + 1e12 / 67e12)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(2 * 2 * 1e9 * 7 / 8 / 450e9
                                           + 4e9 * 31 / 32 / 50e9)
    assert r.bottleneck == "memory"
    assert r.useful_flops_ratio == pytest.approx(1e12 / 3e12)
    assert r.memory_analysis["peak_bytes"] == 3e9
    assert r.memory_analysis["temp_bytes"] == 2e9


# ---------------------------------------------------------------------------
# the kernels' reckoning and meta ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,s,causal,window", [
    (5, 9, True, None), (9, 9, True, 3), (7, 7, False, None),
    (4, 10, False, 4), (100, 100, True, 64), (1, 32, True, None),
    (64, 16, True, None)])
def test_flash_work_counts_the_attended_pairs(t, s, causal, window):
    pairs = int(ref.attention_mask(t, s, causal, window).sum())
    assert fa.attended_pairs(t, s, causal, window) == pairs
    flops, nbytes = fa.work((2, 6, t, 64), (2, 3, s, 64), torch.bfloat16,
                            causal=causal, window=window)
    assert flops == 4 * 64 * 6 * 2 * pairs
    assert nbytes == 2 * (2 * 2 * 6 * t * 64 + 2 * 2 * 3 * s * 64)
    _, with_lse = fa.work((2, 6, t, 64), (2, 3, s, 64), torch.bfloat16,
                          causal=causal, window=window, return_lse=True)
    assert with_lse - nbytes == 4 * 2 * 6 * t


def test_the_training_shape_flash_bound():
    """bf16 flash at qwen2-0.5b's training shape (8, 14, 4096, 64):
    about 2.4e11 flops, 0.243 ms at 989 TFLOP/s."""
    flops, _ = fa.work((8, 14, 4096, 64), (8, 2, 4096, 64), torch.bfloat16)
    assert flops == 4 * 64 * 14 * 8 * 4096 * 4097 // 2
    assert flops / lmesh.PEAK_FLOPS_BF16 * 1e3 == pytest.approx(0.2433,
                                                                abs=1e-4)


def test_scan_work():
    assert ls.work((8, 2304, 2560), torch.float32, False) == \
        (2 * 8 * 2304 * 2560, 3 * 8 * 2304 * 2560 * 4 + 4 * 8 * 2560)
    assert ls.work((3, 5, 7), torch.bfloat16, True)[1] == \
        3 * 3 * 5 * 7 * 2 + 4 * 3 * 7 * 2


def test_meta_ops_give_shapes_and_launch_nothing():
    before = (fa.launches, ls.launches)
    q = torch.empty((2, 4, 16, 64), dtype=torch.bfloat16, device=META)
    k = torch.empty((2, 2, 24, 64), dtype=torch.bfloat16, device=META)
    out, lse = fa.flash_attention(q, k, k, return_lse=True, window=8)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert lse.shape == (2, 4, 16) and lse.dtype == torch.float32
    assert fa.flash_attention(q, k, k).device.type == "meta"
    x = torch.empty((3, 5, 7), device=META)
    hs, last = ls.linear_scan(x, x, torch.empty((3, 7), device=META))
    assert hs.shape == x.shape and last.shape == (3, 7)
    assert (fa.launches, ls.launches) == before
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :, :32], k)


# ---------------------------------------------------------------------------
# op_cost
# ---------------------------------------------------------------------------

def _forward_cost(cfg, batch, seq):
    """op_cost of one no-grad forward of ``cfg`` at (batch, seq) on meta,
    one device."""
    from repro_torch.dist import sharding as sh
    plan = sh.make_plan(cfg, FakeMesh((1, 1), ("data", "model")))
    att = op_cost.Attribution.of(plan, cfg, micro=batch, seq=seq,
                                 kind="prefill", decode_sharded=False)
    model = LM(cfg, device=META)
    tokens = torch.empty((batch, seq), dtype=torch.int32, device=META)

    def step(tokens, on_grads):
        with torch.no_grad():
            return model(tokens)
    live = [(p, 1) for p in model.parameters()] + [(tokens, 1)]
    cost, _ = op_cost.count_step(step, (tokens,), attribution=att,
                                 live=live)
    return cost


@pytest.mark.parametrize("name", ["qwen2-0.5b", "llama3.2-1b", "qwen3-32b"])
def test_dense_forward_counts_2_n_tokens_plus_flash(name):
    cfg = reduced(get_arch(name))
    b, t = 2, 96
    cost = _forward_cost(cfg, b, t)
    hd = cfg.resolved_head_dim
    flash, _ = fa.work((b, cfg.n_heads, t, hd), (b, cfg.n_kv_heads, t, hd),
                       torch.float32)
    # the embedding lookup is a gather: no multiply (an untied table's
    # head is a separate matrix, which n_params counts beside it)
    n = cfg.n_params - (0 if cfg.tied_embeddings else
                        cfg.vocab_size * cfg.d_model)
    want = 2 * n * b * t + cfg.n_layers * flash
    assert cost.counts.flops == pytest.approx(want, rel=0.02)
    kernel = [v for k, v in cost.counts.by_op.items()
              if k.endswith("flash_attention")]
    assert kernel and kernel[0][0] == cfg.n_layers
    params = sum(p.numel() * 4 for p in LM(cfg, device=META).parameters())
    assert cost.arg_bytes == params + b * t * 4
    assert cost.peak_bytes > cost.arg_bytes


def _count(name, mesh, *, batch, shape="train_4k", **extra):
    res = dryrun.run_cell(name, shape, "x".join(map(str, mesh[0])),
                          overrides=_reduced_overrides(name, **extra),
                          batch=batch, mesh=FakeMesh(*mesh))
    assert res["status"] == "ok", res.get("traceback")
    return res


def test_per_device_flops_times_8_equal_the_1x1_count():
    """A (2, 4) mesh where every dim divides (8 heads, 4 kv heads, ff 256,
    vocab 512 over model=4; batch 16 over data=2): the per-device flops
    of a train step, times 8, are the one-device count."""
    kw = dict(batch=16, n_heads=8, n_kv_heads=4)
    one = _count("llama3.2-1b", ((1, 1), ("data", "model")), **kw)
    dev = _count("llama3.2-1b", ((2, 4), ("data", "model")), **kw)
    assert dev["per_device_batch"] == 8 and dev["batch_axes"] == ["data"]
    assert dev["counts"]["flops"] * 8 == pytest.approx(
        one["counts"]["flops"], rel=0.01)
    # TP all-reduces and the DP gradient all-reduce are reckoned
    ops = {(c["what"], c["axis"]) for c in
           dev["roofline"]["collectives"]["list"]}
    assert ("attn output (TP)", "model") in ops
    assert ("mlp output (TP)", "model") in ops
    assert ("DP gradients", "data") in ops
    assert not one["roofline"]["collectives"]["list"]


def test_tp_false_per_device_times_data_equal_the_global_count():
    """qwen2-0.5b (tp=False): the batch takes "model" too, so each of the
    8 devices of a (2, 4) mesh counts an eighth of the step."""
    assert get_arch("qwen2-0.5b").tp is False
    one = _count("qwen2-0.5b", ((1, 1), ("data", "model")), batch=16)
    dev = _count("qwen2-0.5b", ((2, 4), ("data", "model")), batch=16)
    assert dev["batch_axes"] == ["data", "model"]
    assert dev["per_device_batch"] == 2
    assert dev["counts"]["flops"] * 8 == pytest.approx(
        one["counts"]["flops"], rel=0.01)
    assert not dev["fallbacks"]


# ---------------------------------------------------------------------------
# dryrun and report
# ---------------------------------------------------------------------------

def test_list_prints_80_cells():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert dryrun.main(["--list", "--mesh", "both"]) == 0
    lines = buf.getvalue().splitlines()
    assert len(lines) == 80
    assert sum("SKIP" in line for line in lines) == 16


@pytest.mark.parametrize("name,shape", [
    ("qwen2-0.5b", "train_4k"), ("moonshot-v1-16b-a3b", "train_4k"),
    ("recurrentgemma-2b", "long_500k"), ("whisper-medium", "decode_32k"),
    ("mamba2-780m", "prefill_32k"), ("qwen3-32b", "decode_32k"),
    ("internvl2-2b", "prefill_32k"), ("llama3-405b", "train_4k")])
def test_run_cell_at_reduced_configs(name, shape):
    res = dryrun.run_cell(name, shape, "single",
                          overrides=_reduced_overrides(name))
    assert res["status"] == "ok", res.get("traceback")
    roof = res["roofline"]
    assert roof["compute_s"] > 0 and roof["memory_s"] > 0
    assert roof["memory_analysis"]["peak_bytes"] >= \
        roof["memory_analysis"]["argument_bytes"] > 0
    assert res["n_chips"] == 256
    json.dumps(res)


def test_sharded_decode_reckons_its_three_combines():
    """2 kv heads do not divide a 16-way model axis, so with seq_shard
    the decode cache's sequence takes it (the JAX ladder), decode runs
    ``decode_attention_sharded`` and its three combines are reckoned."""
    res = dryrun.run_cell("qwen3-32b", "decode_32k", "16x16",
                          overrides=_reduced_overrides(
                              "qwen3-32b", n_kv_heads=2, n_heads=8,
                              seq_shard=True),
                          mesh=FakeMesh((16, 16), ("data", "model")))
    assert res["status"] == "ok", res.get("traceback")
    whats = [c["what"] for c in res["roofline"]["collectives"]["list"]]
    assert [w for w in whats if w.startswith("sharded decode")] == [
        "sharded decode pmax(m)", "sharded decode psum(l)",
        "sharded decode psum(acc)"]


def test_jax_report_prints_the_ports_cells_alike(jax):
    from repro.launch import report as jreport
    with tempfile.TemporaryDirectory() as d:
        for name, shape in (("qwen2-0.5b", "train_4k"),
                            ("qwen2-0.5b", "long_500k"),
                            ("mamba2-780m", "decode_32k")):
            dryrun.write(dryrun.run_cell(name, shape, "single",
                                         overrides=_reduced_overrides(name)),
                         d)
        rows = report.load(d)
        assert len(rows) == 3
        assert report.markdown(rows) == jreport.markdown(jreport.load(d))
        assert report.summary(rows) == jreport.summary(jreport.load(d))
        before = json.dumps([r.get("roofline") for r in rows],
                            sort_keys=True)
        assert report.reanalyze(d) == 2
        after = json.dumps([r.get("roofline") for r in report.load(d)],
                           sort_keys=True)
    assert after == before


def test_run_cells_in_worker_processes_equal_one_process():
    cells = [("qwen2-0.5b", "prefill_32k", "single"),
             ("mamba2-780m", "long_500k", "multi")]
    over = _reduced_overrides("mamba2-780m")
    one = list(dryrun.run_cells(cells, 1, over))
    two = list(dryrun.run_cells(cells, 2, over))
    assert [r["status"] for r in two] == ["ok", "ok"]
    for a, b in zip(one, two):
        assert a["counts"] == b["counts"] and a["roofline"] == b["roofline"]


def test_main_writes_one_cell():
    with tempfile.TemporaryDirectory() as d:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = dryrun.main(["--arch", "mamba2-780m", "--shape",
                              "long_500k", "--mesh", "1x1", "--out", d,
                              "--override", json.dumps(
                                  _reduced_overrides("mamba2-780m"))])
        assert rc == 0
        res = json.load(open(f"{d}/mamba2-780m__long_500k__1x1.json"))
    assert res["status"] == "ok" and res["n_chips"] == 1
