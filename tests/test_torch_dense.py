"""repro_torch's dense GQA stacks against the JAX model.

``reduced`` configs of qwen2-0.5b (``qkv_bias``), llama3.2-1b and
qwen3-32b (``qk_norm``, untied head): 2 layers of global attention + MLP,
d 128, 4 heads over 2 KV heads of 32, float32.  The JAX package scans
these homogeneous stacks over a layer-stacked param tree and a
layer-stacked cache ``(L, B, ...)``; the weights cross through
``convert.lm_params_from_jax`` (which unstacks them) and the JAX caches
are unstacked the same way (``convert.unstack_layers``) to be compared
layer by layer.  The JAX side runs its Pallas kernels in interpret mode.
Every parameter the JAX init leaves at zero (norm scales, the qkv bias)
is redrawn from a numpy seed on both sides, so each one is exercised.

Tolerance: 1e-5 absolute on logits (scale ~1-3) and caches, as in
``test_torch_lm.py`` -- float32 on both sides, differing in summation
order only (measured ~5e-7).

Global attention's decode writes position p to slot ``min(p, s-1)``:
below ``cache_len >= prompt + new tokens`` the last slot is overwritten
at every step, in both packages alike (pinned below).  On these
attention-only stacks the JAX ``auto`` policy works (its molecule gather
along axis 1 is the batch axis of a layer-stacked cache), and its second
decode of the last prompt token rewrites the same k/v in the same slot,
so the port's ``auto`` gives the JAX ``auto``'s tokens.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import lm_params_from_jax, unstack_layers
from repro_torch.models.lm import LM
from repro_torch.serving import Engine, Request

TOL = 1e-5
CACHE_LEN = 48
DENSE = ("qwen2-0.5b", "llama3.2-1b", "qwen3-32b")


def _redraw_zeros(tree, seed):
    """The JAX param tree (numpy leaves) with every all-zero leaf redrawn
    as normal * 0.1 from ``seed``."""
    import jax
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x)
        if x.dtype == np.float32 and not x.any():
            return rng.standard_normal(x.shape).astype(np.float32) * 0.1
        return x
    return jax.tree.map(leaf, tree)


def jax_model(name: str, seed: int, cache_len: int = CACHE_LEN):
    """The reduced JAX LM of ``name`` with its params, jitted prefill and
    decode, and the port's LM carrying the same weights."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch, reduced
    from repro.models.blocks import Ctx
    from repro.models.lm import LM as JLM

    cfg = reduced(get_arch(name))
    tcfg = t_reduced(t_get_arch(name))
    jm = JLM(cfg)
    tree = _redraw_zeros(jax.tree.map(np.asarray,
                                      jm.init(jax.random.PRNGKey(seed))),
                         seed)
    params = jax.tree.map(jnp.asarray, tree)
    model = LM(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(tcfg, tree))
    ctx = Ctx(cfg=cfg, attn_impl="pallas_interpret",
              scan_impl="pallas_interpret")
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cfg=cfg, tcfg=tcfg, jm=jm, params=params,
        tree=tree, model=model, ctx=ctx,
        prefill=jax.jit(functools.partial(jm.prefill, ctx=ctx,
                                          cache_len=cache_len)),
        decode=jax.jit(functools.partial(jm.decode_step, ctx=ctx)))


@pytest.fixture(scope="module", params=DENSE)
def M(request):
    pytest.importorskip("jax")
    return jax_model(request.param, seed=DENSE.index(request.param))


def _tokens(seed, b, t):
    return np.random.default_rng(seed).integers(1, 512, (b, t)).astype(
        np.int32)


def _np(x):
    return np.asarray(x, dtype=np.float64)


def assert_cache_close(cfg, jcache, tcache, tol=TOL):
    """A JAX cache (layer-stacked for a homogeneous stack) against the
    port's per-layer list."""
    layers = jcache["layers"]
    if isinstance(layers, dict):
        layers = unstack_layers(layers, cfg.n_layers)
    assert len(layers) == len(tcache)
    for i, (jl, tl) in enumerate(zip(layers, tcache)):
        assert set(jl) == set(tl)
        for blk in jl:
            assert set(jl[blk]) == set(tl[blk])
            for name, want in jl[blk].items():
                np.testing.assert_allclose(_np(tl[blk][name]), _np(want),
                                           rtol=0, atol=tol,
                                           err_msg=f"{i}.{blk}.{name}")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

_HELPERS = ("homogeneous", "sub_quadratic", "d_inner", "ssm_heads",
            "n_params", "n_active_params", "resolved_head_dim", "pattern")


@pytest.mark.parametrize("name", sorted(T_ARCHS))
@pytest.mark.parametrize("cut", ["full", "reduced"])
def test_configs_and_their_helpers_equal_jax(name, cut):
    """Every config the port lists: its fields equal the JAX config's
    under the same names, and so do the derived sizes, at full width and
    reduced."""
    pytest.importorskip("jax")
    from repro.configs import get_arch, reduced
    want, got = get_arch(name), t_get_arch(name)
    if cut == "reduced":
        want, got = reduced(want), t_reduced(got)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for h in _HELPERS:
        assert getattr(got, h) == getattr(want, h), h


def test_the_port_lists_only_what_it_runs():
    """Every architecture of the JAX package's ``ARCHS``: the dense, SSM
    and hybrid stacks, MoE, whisper and the VLM stub."""
    assert sorted(T_ARCHS) == ["dbrx-132b", "internvl2-2b", "llama3-405b",
                               "llama3.2-1b", "mamba2-780m",
                               "moonshot-v1-16b-a3b", "qwen2-0.5b",
                               "qwen3-32b", "recurrentgemma-2b",
                               "whisper-medium"]
    for cfg in T_ARCHS.values():
        LM.param_specs(cfg)                # none raises NotImplementedError


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [20, 48, 56])
def test_prefill_logits_and_caches_match_jax(M, t):
    """Inside the cache (20), filling it (48), and past it (56: both keep
    the last 48 positions in order)."""
    toks = _tokens(t, 2, t)
    jl, jc = M.prefill(M.params, M.jnp.asarray(toks))
    tl, tc = M.model.prefill(torch.from_numpy(toks), cache_len=CACHE_LEN)
    assert tuple(tl.shape) == (2, 1, M.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    assert_cache_close(M.cfg, jc, tc)


@pytest.mark.parametrize("prompt,steps", [(20, 3), (46, 4)])
def test_decode_steps_match_jax(M, prompt, steps):
    """(46, 4): positions 48 and 49 lie past the 48-slot cache, so both
    packages overwrite slot 47 (``min(pos, s-1)``)."""
    toks = _tokens(prompt, 2, prompt)
    _, jc = M.prefill(M.params, M.jnp.asarray(toks))
    _, tc = M.model.prefill(torch.from_numpy(toks), cache_len=CACHE_LEN)
    nxt = _tokens(prompt + 1, 2, steps)
    for i in range(steps):
        pos = np.full((2, 1), prompt + i, np.int32)
        jl, jc = M.decode(M.params, M.jnp.asarray(nxt[:, i:i + 1]), jc,
                          M.jnp.asarray(pos))
        tl, tc = M.model.decode_step(torch.from_numpy(nxt[:, i:i + 1]), tc,
                                     torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL, err_msg=f"step {i}")
    assert_cache_close(M.cfg, jc, tc)


def test_decode_after_prefill_equals_full_prefill(M):
    """Prefill 29 tokens, decode the 30th: the JAX full prefill of 30."""
    toks = _tokens(10, 2, 30)
    full, _ = M.prefill(M.params, M.jnp.asarray(toks))
    _, tc = M.model.prefill(torch.from_numpy(toks[:, :29]),
                            cache_len=CACHE_LEN)
    tdec, _ = M.model.decode_step(torch.from_numpy(toks[:, 29:]), tc,
                                  torch.from_numpy(np.full((2, 1), 29,
                                                           np.int32)))
    np.testing.assert_allclose(tdec.numpy(), np.asarray(full), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("name", sorted(T_ARCHS))
def test_cache_specs_describe_the_prefill_cache(name):
    """Every family's prefill cache has the shapes and types of
    ``LM.cache_specs``, which are the JAX ``LM.cache_specs`` less the
    layer axis of a homogeneous stack (an encoder-decoder's
    ``encoder_kv`` in each layer's ``xattn``)."""
    cfg = t_reduced(t_get_arch(name))
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    frames = None
    if cfg.frontend != "none":
        frames = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (3, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model)
        ).astype(np.float32))
    _, tc = model.prefill(torch.from_numpy(_tokens(3, 3, 20)),
                          cache_len=CACHE_LEN, frontend_embeds=frames)
    specs = model.cache_specs(3, CACHE_LEN)
    assert len(specs) == len(tc) == cfg.n_layers
    for spec, layer in zip(specs, tc):
        assert set(spec) == set(layer)
        for blk, d in spec.items():
            assert set(d) == set(layer[blk])
            for name_, s in d.items():
                t = layer[blk][name_]
                assert tuple(t.shape) == s.shape, (blk, name_)
                assert str(t.dtype).removeprefix("torch.") == s.dtype
    pytest.importorskip("jax")
    from repro.configs import get_arch, reduced
    from repro.models.lm import LM as JLM
    jspecs = JLM(reduced(get_arch(name))).cache_specs(3, CACHE_LEN)
    want = jspecs["layers"]
    if "encoder_kv" in jspecs:
        want = {**want, "xattn": jspecs["encoder_kv"]}
    if cfg.homogeneous:
        want = [{blk: {k: s.shape[1:] for k, s in d.items()}
                 for blk, d in want.items()}] * cfg.n_layers
    else:
        want = [{blk: {k: s.shape for k, s in d.items()}
                 for blk, d in layer.items()} for layer in want]
    assert want == [{blk: {k: s.shape for k, s in d.items()}
                     for blk, d in layer.items()} for layer in specs]


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def test_lm_params_from_jax_unstacks_the_layer_stacked_tree(M):
    sd = lm_params_from_jax(M.tcfg, M.tree)
    assert set(sd) == set(LM.param_specs(M.tcfg))
    assert isinstance(M.tree["layers"], dict)
    for i in range(M.cfg.n_layers):
        for blk, d in M.tree["layers"].items():
            for name, leaf in d.items():
                np.testing.assert_array_equal(
                    sd[f"layers.{i}.{blk}.{name}"].numpy(), leaf[i])
    if M.cfg.qkv_bias:
        assert "layers.1.attn.bq" in sd
    if M.cfg.qk_norm:
        assert "layers.1.attn.k_norm" in sd
    if not M.cfg.tied_embeddings:
        assert "lm_head" in sd


def test_lm_params_from_jax_rejects_foreign_stacked_trees(M):
    short = dict(M.tree)
    short["layers"] = M.jax.tree.map(lambda x: x[:1], M.tree["layers"])
    with pytest.raises(ValueError, match="leading dimension"):
        lm_params_from_jax(M.tcfg, short)
    extra = dict(M.tree)
    extra["layers"] = {**M.tree["layers"],
                       "ssd": {"w_in": np.zeros((M.cfg.n_layers, 2, 2))}}
    with pytest.raises(ValueError, match="unexpected"):
        lm_params_from_jax(M.tcfg, extra)
    flat = {k: v for k, v in M.tree.items() if k != "layers"}
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_jax(M.tcfg, flat)


def test_lm_params_from_jax_carries_stacked_bf16_bits(M):
    from repro.configs import get_arch, reduced
    from repro.models.lm import LM as JLM
    name = M.tcfg.name
    cfg = reduced(get_arch(name), dtype="bfloat16", param_dtype="bfloat16")
    tcfg = t_reduced(t_get_arch(name), dtype="bfloat16",
                     param_dtype="bfloat16")
    tree = M.jax.tree.map(np.asarray, JLM(cfg).init(M.jax.random.PRNGKey(2)))
    sd = lm_params_from_jax(tcfg, tree)
    want = tree["layers"]["attn"]["wq"][1]
    got = sd["layers.1.attn.wq"]
    assert got.dtype == torch.bfloat16 and want.dtype.name == "bfloat16"
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------

def _prompts(seed, n, length, shared):
    rng = np.random.default_rng(seed)
    head = rng.integers(1, 512, (shared,), dtype=np.int32)
    return [np.concatenate([head, rng.integers(1, 512, (length - shared,),
                                               dtype=np.int32)])
            for _ in range(n)]


def _serve(engine, prompts, max_new, request=Request, **kw):
    for i, p in enumerate(prompts):
        engine.submit(request(rid=i, tokens=p, max_new=max_new))
    return engine.run(**kw)


@pytest.mark.parametrize("policy", ["flat", "auto"])
def test_engine_tokens_equal_jax(M, policy):
    """4 requests of 40 tokens sharing 32, 6 new; ``auto`` shares one
    molecule of 32 in both packages."""
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    prompts = _prompts(5, 4, 40, 32)
    eng = Engine(M.model, cache_len=46, chunk=8, policy=policy,
                 device="cpu")
    got = _serve(eng, prompts, 6)
    jeng = JEngine(M.jm, M.params, cache_len=46, chunk=8, ctx=M.ctx,
                   policy=policy)
    want = _serve(jeng, prompts, 6, request=JRequest)
    assert got == want
    if policy == "auto":
        plan = eng.last_plan
        assert plan.shares and plan.molecule_tokens.shape == (1, 32)
        assert jeng.last_plan.depth_chunks == plan.depth_chunks


def test_auto_equals_flat_in_logits(M):
    prompts = _prompts(6, 4, 40, 32)
    flat = Engine(M.model, cache_len=46, chunk=8, policy="flat",
                  device="cpu")
    auto = Engine(M.model, cache_len=46, chunk=8, policy="auto",
                  device="cpu")
    assert _serve(flat, prompts, 6, keep_logits=True) == \
        _serve(auto, prompts, 6, keep_logits=True)
    assert auto.last_plan.shares
    np.testing.assert_allclose(auto.logits.numpy(), flat.logits.numpy(),
                               rtol=0, atol=TOL)


def test_a_second_decode_of_the_last_token_is_idempotent_here(M):
    """On an attention-only stack the JAX shared path's second decode of
    the last prompt token writes the same k/v to the same slot: the
    logits stay within 1e-5 of the port's (which decodes it once)."""
    prompts = np.stack(_prompts(7, 4, 40, 32))
    eng = Engine(M.model, cache_len=46, chunk=8, policy="auto", device="cpu")
    plan = eng._plan_prefixes(prompts)
    assert plan.shares
    _, cache, logits = eng._prefill_shared(prompts, plan)
    pos = torch.full((4, 1), 39, dtype=torch.int32)
    _, _, twice = eng._decode(torch.from_numpy(prompts[:, -1:]), cache, pos)
    np.testing.assert_allclose(twice.numpy(), logits.numpy(), rtol=0,
                               atol=TOL)


def test_serve_launcher_defaults_to_qwen2_and_runs_every_arch(capsys):
    """``--arch`` defaults to the JAX launcher's qwen2-0.5b and takes
    every config the port lists; ``--reduced`` runs each on the CPU,
    whisper and the VLM through ``serve_step`` (no prefix policies)."""
    from repro_torch.launch import serve
    stubs = ("audio", "vlm")
    for name in sorted(T_ARCHS):
        out = serve.main(["--arch", name, "--reduced", "--device", "cpu",
                          "--requests", "2", "--prompt-len", "64",
                          "--max-new", "3"])
        assert sorted(out["outputs"]) == [0, 1]
        assert all(len(v) == 3 for v in out["outputs"].values())
        # an SSM stack holds no KV bytes: nothing to share
        assert (out["plan_savings_pct"] > 0) == (
            t_get_arch(name).family not in ("ssm",) + stubs), name
    text = capsys.readouterr().out
    assert text.count("identical outputs") == sum(
        c.family not in stubs for c in T_ARCHS.values())
    assert text.count("serve_step:") == sum(c.family in stubs
                                            for c in T_ARCHS.values())
    serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                "--prompt-len", "32", "--max-new", "2"])
    assert capsys.readouterr().out.startswith("lm qwen2-0.5b (reduced)")


# ---------------------------------------------------------------------------
# the serve path on the card (runs only where a card is present)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def cuda_matches_cpu(cuda, name: str, policy: str, launched):
    """The reduced config of ``name`` (head_dim 64: the flash kernel's
    smallest) in float32 on the card, through its kernels, against the
    plain path on the CPU: same tokens, logits within 1e-4 (float32
    GEMMs and attention summed in another order).  ``launched()`` reads
    the launch count that must grow."""
    cfg = t_reduced(t_get_arch(name), head_dim=64)
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    gpu = LM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    prompts = _prompts(11, 4, 48, 40)
    before = launched()
    outs, logits = [], []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        eng = Engine(model, cache_len=54, chunk=8, policy=policy, device=dev)
        outs.append(_serve(eng, prompts, 6, keep_logits=True))
        logits.append(eng.logits.cpu())
    assert launched() > before
    assert outs[0] == outs[1]
    np.testing.assert_allclose(logits[1].numpy(), logits[0].numpy(), rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["flat", "auto"])
def test_cuda_engine_matches_the_cpu_engine(cuda, policy):
    from repro_torch.kernels import flash_attention as fa
    cuda_matches_cpu(cuda, "qwen2-0.5b", policy,
                     lambda: fa.cuda_core_launches)
