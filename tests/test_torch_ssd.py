"""repro_torch's mamba2 SSD stack against the JAX model.

``reduced(mamba2-780m)``: 2 SSD layers, d 128, d_inner 256 = 8 heads of
32, state 16, chunk 16, conv width 4, float32.  The weights cross
through ``convert.lm_params_from_jax`` (the JAX tree is layer-stacked),
every parameter the JAX init leaves at zero (``dt_bias``, ``a_log``,
``d_skip``, the norm scales) redrawn from a numpy seed on both sides; the
JAX side runs ``linear_scan`` as its Pallas kernel in interpret mode.

Tolerance: 1e-5 absolute, as in ``test_torch_lm.py``.  The port sums the
intra-chunk products in another order than the JAX einsums (the decay
weighted by C.B in place, then one contraction over the chunk) and the
JAX Pallas scan combines steps associatively where the port chains them;
in float32 that moves the block's and the model's outputs (scale ~1-3)
by ~1e-6.  One test holds the recurrence alone on unit-normal x, B and C
(``TOL_RAW``): its outputs reach |y| ~ 30-47, where one float32 step is
2^-19 * 32 ~ 3.8e-6, and the reordered sums part by up to 1.7e-5
(measured, ~4.5 steps); it takes 1e-4.

The JAX engine's ``auto`` policy, when its plan declines to share,
prefills the whole prompt and then decodes the last prompt token a
second time (``serving/engine.py:680-689``), which advances an SSD state
twice.  An SSM stack holds no KV bytes, so its plan never shares: the
port's ``auto`` serves exactly as ``flat`` (and as the JAX ``flat``),
and the test pins that the JAX double decode moves the logits.
"""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import blocks
from repro_torch.models.lm import LM
from repro_torch.serving import Engine, Request
from test_torch_dense import (_serve, _tokens, assert_cache_close,
                              cuda_matches_cpu, jax_model)

TOL = 1e-5
TOL_RAW = 1e-4          # the recurrence alone, outputs up to ~47
NAME = "mamba2-780m"



@pytest.fixture(autouse=True)
def _no_grad():
    """The blocks run here as the serve path runs them, recording no
    gradient (the port's parameters are trainable)."""
    with torch.no_grad():
        yield

@pytest.fixture(scope="module")
def M():
    pytest.importorskip("jax")
    return jax_model(NAME, seed=5)


@pytest.fixture(scope="module")
def blk(M):
    """Layer 0's SSD block in both packages, and the JAX entry points."""
    from repro.models import blocks as jblocks
    lp = M.jax.tree.map(lambda x: x[0], M.params["layers"]["ssd"])
    return types.SimpleNamespace(
        jb=jblocks, p=lp, mod=M.model.layers[0].ssd,
        apply=M.jax.jit(functools.partial(jblocks.ssd_apply, M.ctx,
                                          return_cache=True)),
        step=M.jax.jit(functools.partial(jblocks.ssd_apply, M.ctx)),
        chunked=M.jax.jit(functools.partial(jblocks._ssd_chunked, M.cfg,
                                            ctx=M.ctx)))


def _ssd_inputs(seed, b, t, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    da = -rng.uniform(0.01, 1.0, (b, t, h)).astype(np.float32)
    bb = rng.standard_normal((b, t, n)).astype(np.float32)
    cc = rng.standard_normal((b, t, n)).astype(np.float32)
    return x, da, bb, cc


def _np(x):
    return np.asarray(x, dtype=np.float64)


# ---------------------------------------------------------------------------
# the SSD recurrence and the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [32, 20, 7])
def test_ssd_chunked_matches_jax(M, blk, t):
    """T a multiple of the 16-step chunk (32), not one (20: padded with
    no-op steps), and shorter than it (7: one chunk of 7)."""
    args = _ssd_inputs(t, 2, t, 8, 32, 16)
    jy, jlast = blk.chunked(*map(M.jnp.asarray, args))
    y, last = blocks.ssd_chunked(M.tcfg, *map(torch.from_numpy, args))
    assert tuple(y.shape) == (2, t, 8, 32) and tuple(last.shape) == \
        (2, 8, 16, 32)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=0, atol=TOL_RAW)
    np.testing.assert_allclose(_np(last), _np(jlast), rtol=0, atol=TOL_RAW)


@pytest.mark.parametrize("t,chunks", [(32, 2), (20, 2), (7, 1)])
def test_the_inter_chunk_recurrence_runs_on_linear_scan(monkeypatch, t,
                                                        chunks):
    """One ``linear_scan`` call at (B*H, n_chunks, N*P), contiguous
    float32 (what the CUDA kernel takes), whose ``a`` is each chunk's
    decay repeated over the N*P channels."""
    cfg = t_reduced(t_get_arch(NAME))
    calls = []
    real = ops.linear_scan

    def spy(x, a, h0=None):
        calls.append((tuple(x.shape), x.dtype, x.is_contiguous(),
                      a.is_contiguous(), h0,
                      bool((a == a[..., :1]).all())))
        return real(x, a, h0)

    monkeypatch.setattr(ops, "linear_scan", spy)
    blocks.ssd_chunked(cfg, *map(torch.from_numpy,
                                 _ssd_inputs(1, 2, t, 8, 32, 16)))
    assert calls == [((2 * 8, chunks, 16 * 32), torch.float32, True, True,
                      None, True)]


@pytest.mark.parametrize("t", [32, 20])
def test_ssd_apply_matches_jax(M, blk, t):
    x = np.random.default_rng(t).standard_normal((2, t, 128)).astype(
        np.float32)
    jy, jc = blk.apply(blk.p, M.jnp.asarray(x))
    y, c = blk.mod(torch.from_numpy(x), return_cache=True)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=0, atol=TOL)
    for name in ("state", "conv"):
        np.testing.assert_allclose(_np(c[name]), _np(jc[name]), rtol=0,
                                   atol=TOL, err_msg=name)
    specs = blocks.ssd_cache_specs(M.tcfg, 2)
    assert {k: tuple(v.shape) for k, v in c.items()} == \
        {k: s.shape for k, s in specs.items()}
    assert blk.mod(torch.from_numpy(x))[1] is None


@pytest.mark.parametrize("t", [16, 21])
def test_ssd_decode_step_equals_a_full_prefill(M, blk, t):
    """Prefill t tokens, then one decode step: the output of a prefill of
    t + 1 at its last position, in the port and in the JAX step alike."""
    x = np.random.default_rng(t).standard_normal((2, t + 1, 128)).astype(
        np.float32)
    full, _ = blk.mod(torch.from_numpy(x))
    _, cache = blk.mod(torch.from_numpy(x[:, :t]), return_cache=True)
    y, c = blk.mod(torch.from_numpy(x[:, t:]), cache=cache)
    np.testing.assert_allclose(_np(y), _np(full[:, t:]), rtol=0, atol=TOL)
    _, jcache = blk.apply(blk.p, M.jnp.asarray(x[:, :t]))
    jy, jc = blk.step(blk.p, M.jnp.asarray(x[:, t:]), cache=jcache)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=0, atol=TOL)
    for name in ("state", "conv"):
        np.testing.assert_allclose(_np(c[name]), _np(jc[name]), rtol=0,
                                   atol=TOL, err_msg=name)
    with pytest.raises(ValueError, match="one token"):
        blk.mod(torch.from_numpy(x[:, :2]), cache=cache)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [20, 32, 40])
def test_prefill_logits_and_caches_match_jax(M, t):
    toks = _tokens(t, 2, t)
    jl, jc = M.prefill(M.params, M.jnp.asarray(toks))
    tl, tc = M.model.prefill(torch.from_numpy(toks), cache_len=48)
    assert tuple(tl.shape) == (2, 1, M.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    assert_cache_close(M.cfg, jc, tc)
    assert [set(c) for c in tc] == [{"ssd"}] * M.cfg.n_layers


@pytest.mark.parametrize("prompt", [16, 21])
def test_decode_steps_match_jax(M, prompt):
    toks = _tokens(prompt, 2, prompt)
    _, jc = M.prefill(M.params, M.jnp.asarray(toks))
    _, tc = M.model.prefill(torch.from_numpy(toks), cache_len=48)
    nxt = _tokens(prompt + 1, 2, 3)
    for i in range(3):
        pos = np.full((2, 1), prompt + i, np.int32)
        jl, jc = M.decode(M.params, M.jnp.asarray(nxt[:, i:i + 1]), jc,
                          M.jnp.asarray(pos))
        tl, tc = M.model.decode_step(torch.from_numpy(nxt[:, i:i + 1]), tc,
                                     torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL, err_msg=f"step {i}")
    assert_cache_close(M.cfg, jc, tc)


def test_decode_after_prefill_equals_full_prefill(M):
    toks = _tokens(11, 2, 33)
    full, _ = M.prefill(M.params, M.jnp.asarray(toks))
    _, tc = M.model.prefill(torch.from_numpy(toks[:, :32]), cache_len=48)
    tdec, _ = M.model.decode_step(torch.from_numpy(toks[:, 32:]), tc,
                                  torch.from_numpy(np.full((2, 1), 32,
                                                           np.int32)))
    np.testing.assert_allclose(tdec.numpy(), np.asarray(full), rtol=0,
                               atol=TOL)


def test_lm_params_from_jax_unstacks_the_ssd_tree(M):
    sd = lm_params_from_jax(M.tcfg, M.tree)
    assert set(sd) == set(LM.param_specs(M.tcfg))
    assert not any(".mlp." in k or ".attn." in k for k in sd)
    for name, leaf in M.tree["layers"]["ssd"].items():
        for i in range(M.cfg.n_layers):
            np.testing.assert_array_equal(sd[f"layers.{i}.ssd.{name}"].numpy(),
                                          leaf[i])


def test_generator_init_follows_the_ssd_specs():
    cfg = t_reduced(t_get_arch(NAME))
    sd = LM(cfg, device="cpu",
            generator=torch.Generator().manual_seed(3)).state_dict()
    assert set(sd) == set(LM.param_specs(cfg))
    assert torch.all(sd["layers.1.ssd.a_log"] == 0)
    assert tuple(sd["layers.0.ssd.w_in"].shape) == \
        (128, 2 * 256 + 2 * 16 + 8)
    assert 0.015 < float(sd["layers.0.ssd.w_in"].std()) < 0.025
    assert 0.007 < float(sd["layers.0.ssd.w_out"].std()) < 0.013


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------

def _prompts(seed, n, length, shared):
    rng = np.random.default_rng(seed)
    head = rng.integers(1, 512, (shared,), dtype=np.int32)
    return [np.concatenate([head, rng.integers(1, 512, (length - shared,),
                                               dtype=np.int32)])
            for _ in range(n)]


def test_flat_tokens_equal_jax_flat_tokens(M):
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    prompts = _prompts(2, 4, 40, 32)
    got = _serve(Engine(M.model, cache_len=46, chunk=8, policy="flat",
                        device="cpu"), prompts, 6)
    want = _serve(JEngine(M.jm, M.params, cache_len=46, chunk=8, ctx=M.ctx,
                          policy="flat"), prompts, 6, request=JRequest)
    assert got == want


def test_auto_plans_no_sharing_and_serves_as_flat(M):
    """No KV bytes, so no molecule: ``auto`` equals ``flat`` in tokens and
    logits; the JAX engine plans the same and its byte count is 0 too."""
    from repro.serving import Engine as JEngine
    prompts = _prompts(3, 4, 40, 32)
    flat = Engine(M.model, cache_len=46, chunk=8, policy="flat",
                  device="cpu")
    auto = Engine(M.model, cache_len=46, chunk=8, policy="auto",
                  device="cpu")
    assert _serve(auto, prompts, 6, keep_logits=True) == \
        _serve(flat, prompts, 6, keep_logits=True)
    assert not auto.last_plan.shares and auto.last_plan.savings_pct == 0
    np.testing.assert_array_equal(auto.logits.numpy(), flat.logits.numpy())
    jeng = JEngine(M.jm, M.params, cache_len=46, chunk=8, ctx=M.ctx)
    assert auto._kv_bytes_per_token() == jeng._kv_bytes_per_token() == 0.0
    jplan = jeng._plan_prefixes(np.stack(prompts))
    assert (jplan.depth_chunks, jplan.cost_shared) == \
        (auto.last_plan.depth_chunks, auto.last_plan.cost_shared)


def test_the_jax_auto_double_decode_moves_the_ssd_logits(M):
    """What the JAX ``auto`` does on a plan that declines to share: a
    full prefill, then the last prompt token decoded once more.  On SSD
    layers that advances each state twice and moves the next-token
    logits far past 1e-5; the port's ``auto`` does not do it."""
    toks = np.stack(_prompts(4, 4, 40, 32))
    jl, jc = M.prefill(M.params, M.jnp.asarray(toks))
    twice, _ = M.decode(M.params, M.jnp.asarray(toks[:, -1:]), jc,
                        M.jnp.asarray(np.full((4, 1), 39, np.int32)))
    assert np.abs(np.asarray(twice) - np.asarray(jl)).max() > 10 * TOL
    eng = Engine(M.model, cache_len=46, chunk=8, policy="auto", device="cpu")
    _, _, logits = eng._prefill_shared(toks, eng._plan_prefixes(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl)[:, -1],
                               rtol=0, atol=TOL)



@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["flat", "auto"])
def test_cuda_engine_matches_the_cpu_engine(cuda, policy):
    from repro_torch.kernels import linear_scan as ls
    cuda_matches_cpu(cuda, NAME, policy, lambda: ls.launches)
