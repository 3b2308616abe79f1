"""repro_torch's layout policy against the JAX package's, on the CPU.

The config fields (``tp``, ``seq_shard`` among them), ``SHAPES`` and
``applicable``, ``rdf_sensor``; every parameter's and cache's logical
axes (the port's per-layer specs equal JAX's with the leading "layers"
axis stripped); ``dist.sharding``'s specs -- every parameter, cache and
optimizer-state leaf, ``act_spec``, ``qkv_specs``,
``layer_compute_specs``, the train-state shardings and the fallbacks
they record -- for every ``ARCHS`` name on mesh-like fakes of five
shapes; ``choose_mesh_shape`` and ``remesh`` with a checkpoint restored
onto its mesh; and ``decode_attention_sharded`` against JAX's (on four
forced host devices, in a subprocess) and the unsharded decode, within
2e-5 (``tests/test_chunked_attention.py``'s tolerance), and an LM decode
through it within 1e-5.  Integer and spec results must be equal.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import applicable as t_applicable
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import rdf_sensor as t_rdf
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import jax_leaves
from repro_torch.dist import sharding as tsh
from repro_torch.dist.elastic import MAX_MODEL, choose_mesh_shape, remesh
from repro_torch.dist.mesh import make_test_mesh
from repro_torch.kernels.chunked_attention import (NEG_INF,
                                                   decode_attention,
                                                   decode_attention_sharded)
from repro_torch.models import lm as tlm
from repro_torch.models.common import TSpec
from repro_torch.models.lm import LM

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(T_ARCHS)
MESHES = (((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")), ((32, 8), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
DECODE_TOL = 2e-5


class FakeMesh:
    """``axis_names`` and a ``devices`` array of the mesh's shape, no
    devices (the rule logic reads nothing else)."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape, object)
        self.axis_names = names


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _flat(tree, prefix=""):
    """(dotted path, leaf) of nested dicts, lists and tuples; specs and
    shardings (tuples themselves) are leaves."""
    if isinstance(tree, tsh.Sharding) or \
            type(tree).__name__ == "PartitionSpec":
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _strip(axes):
    return axes[1:] if axes and axes[0] == "layers" else axes


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cut", ["full", "reduced"])
@pytest.mark.parametrize("name", NAMES)
def test_config_fields_equal_jax(jax, name, cut):
    from repro.configs import get_arch, reduced
    want, got = get_arch(name), t_get_arch(name)
    if cut == "reduced":
        want, got = reduced(want), t_reduced(got)
    w, g = dataclasses.asdict(want), dataclasses.asdict(got)
    assert g == w
    assert (got.tp, got.seq_shard) == (want.tp, want.seq_shard)


def test_shapes_applicable_and_rdf_sensor_equal_jax(jax):
    from repro.configs import ARCHS, SHAPES, applicable
    from repro.configs import rdf_sensor
    assert {k: dataclasses.asdict(v) for k, v in T_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in SHAPES.items()}
    for name in NAMES:
        for shape in SHAPES:
            assert t_applicable(T_ARCHS[name], T_SHAPES[shape]) == \
                applicable(ARCHS[name], SHAPES[shape]), (name, shape)
    for w in ("D1", "D1D2", "D1D2D3", "SMALL"):
        assert dataclasses.asdict(getattr(t_rdf, w)) == \
            dataclasses.asdict(getattr(rdf_sensor, w)), w


def test_tspec_rank_check():
    with pytest.raises(ValueError, match="rank"):
        TSpec((2, 3), "float32", ("embed",))
    assert TSpec((2, 3), "float32").axes == ()


# ---------------------------------------------------------------------------
# logical axes
# ---------------------------------------------------------------------------

def _jax_model(name):
    from repro.configs import get_arch
    from repro.models.lm import LM as JLM
    return JLM(get_arch(name))


def _cache_pairs(name, batch=4, cache_len=64):
    """(port cache TSpec, JAX cache TSpec) pairs: the port's per-layer
    dicts against the JAX tree (a stacked leaf per layer; an
    encoder-decoder's cross K/V under ``encoder_kv``)."""
    cfg = t_get_arch(name)
    got = [tlm._layer_cache_specs(cfg, k, batch, cache_len)
           for k in cfg.pattern]
    want = _jax_model(name).cache_specs(batch, cache_len)
    pairs = []
    for i, layer in enumerate(got):
        for blk, specs in layer.items():
            for leaf, s in specs.items():
                if blk == "xattn":
                    pairs.append((s, want["encoder_kv"][leaf], i))
                elif cfg.homogeneous:
                    pairs.append((s, want["layers"][blk][leaf], i))
                else:
                    pairs.append((s, want["layers"][i][blk][leaf], None))
    return pairs


@pytest.mark.parametrize("name", NAMES)
def test_tspec_axes_equal_jax(jax, name):
    cfg = t_get_arch(name)
    want = dict(_flat(_jax_model(name).param_specs()))
    got = jax_leaves(cfg, LM.param_specs(cfg))
    assert set(got) == set(want)
    for path, w in want.items():
        for s in (got[path] if isinstance(got[path], list) else [got[path]]):
            assert s.axes == _strip(w.axes), path
            assert s.shape == (w.shape[1:] if isinstance(got[path], list)
                               else w.shape), path
    pairs = _cache_pairs(name)
    assert pairs
    for s, w, layer in pairs:
        assert s.axes == _strip(w.axes)
        assert s.shape == (w.shape[1:] if layer is not None else w.shape)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def _layer_trees(cfg):
    return [tlm._layer_specs(cfg, k) for k in cfg.pattern]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str,
                                                                    m[0])))
@pytest.mark.parametrize("name", NAMES)
def test_specs_and_fallbacks_equal_jax(jax, name, mesh):
    """Every spec the plan gives equals JAX's (the port's per-layer
    parameter specs against the stacked leaf's without its "layers"
    entry), called in the same order on both sides, so the fallback
    lists are equal too."""
    from repro.configs import get_arch
    from repro.dist import sharding as jsh
    shape, names = mesh
    cfg, jcfg = t_get_arch(name), get_arch(name)
    plan = tsh.make_plan(cfg, FakeMesh(shape, names))
    jplan = jsh.make_plan(jcfg, FakeMesh(shape, names))
    assert (plan.tp, plan.fsdp, plan.seq_shard, plan.dp_axes,
            plan.ladder, plan.axis_sizes) == \
        (jplan.tp, jplan.fsdp, jplan.seq_shard, jplan.dp_axes,
         jplan.ladder, jplan.axis_sizes)
    jm = _jax_model(name)

    # parameters
    want = dict(_flat(jm.param_specs()))
    got = jax_leaves(cfg, LM.param_specs(cfg))
    for path, w in want.items():
        ws = tuple(jsh.spec_for(jplan, w))
        for s in (got[path] if isinstance(got[path], list) else [got[path]]):
            gs = tuple(tsh.spec_for(plan, s))
            assert gs == (ws[1:] if isinstance(got[path], list) else ws), \
                path
    # caches
    for s, w, layer in _cache_pairs(name, batch=128, cache_len=32_768):
        ws = tuple(jsh.spec_for(jplan, w))
        assert tuple(tsh.spec_for(plan, s)) == \
            (ws[1:] if layer is not None else ws)
    # optimizer state: per JAX leaf, stacked, as the port keeps it
    want = dict(_flat(jsh.opt_state_specs(jcfg, jm.param_specs())))
    got = dict(_flat(tsh.opt_state_specs(cfg, LM.param_specs(cfg))))
    assert sorted(got) == sorted(want)     # JAX sorts a dict's keys
    for path in want:
        assert (got[path].shape, got[path].axes) == \
            (want[path].shape, want[path].axes), path
        assert tuple(tsh.spec_for(plan, got[path])) == \
            tuple(jsh.spec_for(jplan, want[path])), path
    # activations, attention, layers, train state
    for batch, seq, decode in ((256, 4096, False), (32, 32_768, False),
                               (128, 32_768, True), (7, 1500, False)):
        assert tuple(tsh.act_spec(plan, batch, seq=seq, decode=decode)) == \
            tuple(jsh.act_spec(jplan, batch, seq=seq, decode=decode))
        assert [tuple(x) for x in tsh.qkv_specs(plan, cfg, batch, seq=seq)] \
            == [tuple(x) for x in jsh.qkv_specs(jplan, jcfg, batch,
                                                seq=seq)]
        assert tuple(tsh.batch_sharding(plan, batch).spec) == \
            (jsh._batch_entry(jplan, batch),)
    jl = jsh.layer_compute_specs(jplan, jm.param_specs()["layers"])
    tl = tsh.layer_compute_specs(plan, _layer_trees(cfg))
    for i, layer in enumerate(tl):
        ref = jl if cfg.homogeneous else jl[i]
        for path, s in _flat(layer):
            r = dict(_flat(ref))[path]
            assert tuple(s) == tuple(r), (i, path)
    state = tsh.train_state_shardings(plan, cfg, LM.param_specs(cfg))
    jopt = dict(_flat(jsh.opt_state_specs(jcfg, jm.param_specs())))
    for path, sh_ in _flat(state.opt):
        assert tuple(sh_.spec) == tuple(jsh.spec_for(jplan, jopt[path]))
    for path, sh_ in _flat(state.params):
        key = path.rsplit(".", 1)[0] if path.rsplit(".", 1)[-1].isdigit() \
            and path.rsplit(".", 1)[0] in dict(_flat(jm.param_specs())) \
            else path
        ws = tuple(jsh.spec_for(jplan, dict(_flat(jm.param_specs()))[key]))
        assert tuple(sh_.spec) == (ws[1:] if key != path else ws), path
    assert tuple(state.step.spec) == ()
    assert plan.fallbacks == jplan.fallbacks


def test_the_compaction_plan_is_the_tp_plan():
    mesh = FakeMesh((2, 2, 2), ("pod", "data", "model"))
    short = tsh.make_plan(mesh)
    full = tsh.make_plan(dataclasses.replace(t_get_arch("llama3.2-1b"),
                                             fsdp=False, seq_shard=False),
                         mesh)
    assert (short.tp, short.dp_axes, short.ladder) == \
        (full.tp, full.dp_axes, full.ladder) == \
        (True, ("pod", "data"), (("pod", "data"), ("data",), ()))


def test_train_state_shapes_mirror_the_optimizer():
    from repro_torch.train import make_optimizer
    from repro_torch.train.train_step import init_train_state
    for name in ("qwen2-0.5b", "llama3-405b"):       # AdamW, Adafactor
        cfg = t_reduced(t_get_arch(name))
        model = LM(cfg, device="meta")
        want = init_train_state(model, make_optimizer(cfg))
        got = tsh.train_state_shapes(cfg, model)
        w, g = dict(_flat(want.opt)), dict(_flat(got.opt))
        assert list(g) == list(w)
        assert all(g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
                   and g[k].device.type == "meta" for k in w)
        w, g = dict(_flat(want.params)), dict(_flat(got.params))
        assert list(g) == list(w)
        assert all(g[k].shape == w[k].shape for k in w)
        assert got.step == 0


# ---------------------------------------------------------------------------
# elastic
# ---------------------------------------------------------------------------

def test_choose_mesh_shape_equals_jax(jax):
    from repro.dist.elastic import choose_mesh_shape as jchoose
    for n in range(1, 1025):
        assert choose_mesh_shape(n, max_model=16) == jchoose(n), n
        d, m = choose_mesh_shape(n)
        assert d * m == n and m <= MAX_MODEL == 8
    assert choose_mesh_shape(512) == (64, 8)
    with pytest.raises(ValueError):
        choose_mesh_shape(0)


def test_remesh():
    mesh = remesh(devices=["cpu"] * 12)
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (3, 4)
    assert remesh(12, tp_pref=3, devices=["cpu"] * 16).devices.shape == \
        (4, 3)
    assert remesh(8, tp_pref=3, devices=["cpu"] * 8).devices.shape == (1, 8)
    with pytest.raises(ValueError, match="alive"):
        remesh(9, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            remesh(2)                            # cuda:0, cuda:1


def test_restore_onto_the_remeshed_mesh_round_trips():
    """A train state saved, then restored with the shardings of the plan
    on ``remesh``'s mesh: every tensor bit for bit, on the mesh's device,
    the step equal."""
    from repro_torch.train import make_optimizer
    from repro_torch.train.train_step import init_train_state
    cfg = t_reduced(t_get_arch("qwen2-0.5b"))
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, make_optimizer(cfg))
    for leaf in state.opt["m"].values():
        leaf.normal_(generator=torch.Generator().manual_seed(1))
    state = state._replace(step=7)
    mesh = remesh(devices=["cpu"] * 4)
    shardings = tsh.train_state_shardings(tsh.make_plan(cfg, mesh), cfg,
                                          LM.param_specs(cfg))
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(state, 7)
        ck.wait()
        like = tsh.train_state_shapes(cfg)
        like = like._replace(params={k: [torch.zeros_like(t, device="cpu")
                                         for t in v] if isinstance(v, list)
                                     else torch.zeros_like(v, device="cpu")
                                     for k, v in like.params.items()},
                             opt=_zeros(like.opt))
        restored, step = ck.restore(like, shardings=shardings)
    assert step == 7 and restored.step == 7
    want, got = dict(_flat(state)), dict(_flat(restored))
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert got[k].device == mesh.devices.flat[0]
            assert torch.equal(got[k], want[k]), k


def _zeros(tree):
    """A meta tree as CPU zeros."""
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree, device="cpu")


# ---------------------------------------------------------------------------
# sharded flash-decode
# ---------------------------------------------------------------------------

def _decode_inputs(seed=4, b=2, hkv=2, g=4, s=48, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    bias = np.where(rng.uniform(size=(b, s)) > 0.5, 0.0,
                    NEG_INF).astype(np.float32)
    return q, k, v, bias


_JAX_SHARDED = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh
from repro.kernels.chunked_attention import decode_attention_sharded
q, k, v, bias = (np.load(sys.argv[1] + f"/{n}.npy") for n in "qkvb")
mesh = make_mesh((1, 4), ("data", "model"))
with mesh:
    out = jax.jit(lambda *a: decode_attention_sharded(
        *a, mesh=mesh, q_spec=P(None, None, None, None),
        kv_spec=P(None, None, "model", None),
        bias_spec=P(None, "model")))(q, k, v, bias)
np.save(sys.argv[1] + "/out.npy", np.asarray(out))
print(len(jax.devices()))
"""


def test_decode_attention_sharded_equals_jax_and_unsharded(jax):
    q, k, v, bias = _decode_inputs()
    with tempfile.TemporaryDirectory() as d:
        for n, a in zip("qkvb", (q, k, v, bias)):
            np.save(f"{d}/{n}.npy", a)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, "-c", _JAX_SHARDED, d],
                             capture_output=True, text=True, env=env,
                             timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        assert res.stdout.split()[-1] == "4"
        want = np.load(f"{d}/out.npy")
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    mesh = make_test_mesh((1, 4), ("data", "model"))
    got = decode_attention_sharded(*t, mesh=mesh)
    np.testing.assert_allclose(got.numpy(), want, atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    np.testing.assert_allclose(got.numpy(), decode_attention(*t).numpy(),
                               atol=DECODE_TOL, rtol=DECODE_TOL)
    # the batch split over "data" too, and a fully masked shard
    t[3][:, :12] = NEG_INF
    mesh = make_test_mesh((2, 4), ("data", "model"))
    got = decode_attention_sharded(
        *t, mesh=mesh, q_spec=tsh.P("data", None, None, None),
        kv_spec=tsh.P("data", None, "model", None),
        bias_spec=tsh.P("data", "model"))
    np.testing.assert_allclose(got.numpy(), decode_attention(*t).numpy(),
                               atol=DECODE_TOL, rtol=DECODE_TOL)


def test_decode_attention_sharded_refuses_what_it_cannot_split():
    t = [torch.from_numpy(a) for a in _decode_inputs(s=50)]
    mesh = make_test_mesh((1, 4), ("data", "model"))
    with pytest.raises(ValueError, match="divide"):
        decode_attention_sharded(*t, mesh=mesh)           # 50 % 4
    t = [torch.from_numpy(a) for a in _decode_inputs()]
    with pytest.raises(ValueError, match="splits S"):
        decode_attention_sharded(*t, mesh=mesh,
                                 kv_spec=tsh.P(None, "model", None, None))
    with pytest.raises(ValueError, match="batch alike"):
        decode_attention_sharded(*t, mesh=mesh,
                                 kv_spec=tsh.P("data", None, "model", None))


@pytest.mark.parametrize("name", ["qwen3-32b", "recurrentgemma-2b"])
def test_lm_decode_through_decode_kv_specs_equals_plain(name):
    """A reduced LM's prefill and three decode steps with the cache's
    sequence split over a (1, 4) CPU mesh give the logits of the same LM
    without it, within 1e-5 (float32)."""
    cfg = t_reduced(t_get_arch(name))
    mesh = make_test_mesh((1, 4), ("data", "model"))
    specs = (tsh.P(None, None, None, None), tsh.P(None, None, "model", None),
             tsh.P(None, "model"))
    plain = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    sharded = LM(cfg, device="cpu", mesh=mesh, decode_kv_specs=specs)
    sharded.load_state_dict(plain.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 12)))
    outs = []
    for model in (plain, sharded):
        logits, cache = model.prefill(tokens, cache_len=40)
        steps = [logits]
        tok = logits[:, -1].argmax(-1, keepdim=True)
        for i in range(3):
            pos = torch.full((2, 1), 12 + i, dtype=torch.int32)
            logits, cache = model.decode_step(tok, cache, pos)
            steps.append(logits)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        outs.append(torch.cat(steps, 1))
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=1e-5,
                               rtol=0)
