"""repro_torch serving against the JAX serving path.

The prefix planner must equal JAX's exactly (depth, molecules,
``instance_of``, costs).  The ``Engine`` runs the reduced
recurrentgemma-2b (3 layers, window 32, float32) with the JAX weights
carried across; the JAX side runs its Pallas kernels in interpret mode.

* ``flat`` tokens equal the JAX ``flat`` tokens for prompts inside the
  window.
* The port's ``auto`` equals its ``flat`` in tokens and in next-token
  logits (tolerance 1e-5 absolute at logit scale ~2.7), where the JAX
  ``auto`` crashes (fault 1: ``Engine._prefill_shared`` gathers the
  molecule cache along axis 1, which is not the batch axis of a
  per-layer cache).  A second decode of the last prompt token (fault 2,
  the JAX shared path's double decode) moves those logits by far more
  than 1e-5, so the logits check would catch it.
"""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.lm import LM
from repro_torch.serving import (PREFIX_POLICIES, Engine, Request, expand,
                                 plan_prefix_sharing, prefix_edges_cost)

TOL = 1e-5


@pytest.fixture(scope="module")
def S():
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_arch, reduced
    from repro.models.blocks import Ctx
    from repro.models.lm import LM as JLM
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    from repro.serving import prefix_factorization as jpf

    cfg = reduced(get_arch("recurrentgemma-2b"))
    tcfg = t_reduced(t_get_arch("recurrentgemma-2b"))
    jm = JLM(cfg)
    params = jm.init(jax.random.PRNGKey(1))
    model = LM(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(
        tcfg, jax.tree.map(np.asarray, params)))
    ctx = Ctx(cfg=cfg, attn_impl="pallas_interpret",
              scan_impl="pallas_interpret")
    return types.SimpleNamespace(
        pf=jpf, model=model, jax=jax, jm=jm, params=params, ctx=ctx,
        jengine=functools.partial(JEngine, jm, params, ctx=ctx),
        JRequest=JRequest)


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


# ---------------------------------------------------------------------------
# the prefix planner (numpy on both sides: identical)
# ---------------------------------------------------------------------------

def _token_sets():
    rng = np.random.default_rng(0)
    shared = np.stack(_prompts(1, 6, 64, 48))
    distinct = rng.integers(0, 50, (5, 40)).astype(np.int32)
    same = np.repeat(rng.integers(0, 50, (1, 32)), 4, 0).astype(np.int32)
    two = np.concatenate([np.repeat(rng.integers(0, 9, (2, 24)), 3, 0),
                          rng.integers(0, 9, (6, 8))], 1).astype(np.int32)
    return {"shared": shared, "distinct": distinct, "same": same, "two": two}


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("name", ["shared", "distinct", "same", "two"])
def test_plan_prefix_sharing_identical_to_jax(S, name, chunk):
    toks = _token_sets()[name]
    got = plan_prefix_sharing(toks, chunk=chunk, kv_bytes_per_token=96.0)
    want = S.pf.plan_prefix_sharing(toks, chunk=chunk,
                                    kv_bytes_per_token=96.0)
    assert (got.depth_chunks, got.chunk, got.suffix_start) == \
        (want.depth_chunks, want.chunk, want.suffix_start)
    np.testing.assert_array_equal(got.molecule_tokens, want.molecule_tokens)
    np.testing.assert_array_equal(got.instance_of, want.instance_of)
    assert (got.cost_shared, got.cost_unshared) == \
        (want.cost_shared, want.cost_unshared)
    assert got.savings_pct == want.savings_pct
    for d in range(toks.shape[1] // chunk + 1):
        assert prefix_edges_cost(toks, d, chunk, 96.0) == \
            S.pf.prefix_edges_cost(toks, d, chunk, 96.0)
    suffixes = toks[:, got.suffix_start:]
    np.testing.assert_array_equal(expand(got, suffixes), toks)


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------

def test_flat_tokens_equal_jax_flat_tokens(S):
    """Prompts inside the window (24 <= 32), 4 requests, 6 new tokens."""
    prompts = _prompts(2, 4, 24, 16)
    got = _serve(Engine(S.model, cache_len=30, chunk=8, policy="flat",
                        device="cpu"), prompts, 6)
    want = _serve(S.jengine(cache_len=30, chunk=8, policy="flat"), prompts,
                  6, request=S.JRequest)
    assert got == want


@pytest.mark.parametrize("length,shared", [(24, 16), (48, 40)])
def test_auto_equals_flat_where_jax_auto_crashes(S, length, shared):
    """Inside the window (24) and past it with a wrap (48 % 32 != 0)."""
    prompts = _prompts(length, 4, length, shared)
    flat = Engine(S.model, cache_len=length + 6, chunk=8, policy="flat",
                  device="cpu")
    auto = Engine(S.model, cache_len=length + 6, chunk=8, policy="auto",
                  device="cpu")
    t_flat = _serve(flat, prompts, 6, keep_logits=True)
    t_auto = _serve(auto, prompts, 6, keep_logits=True)
    plan = auto.last_plan
    assert plan.shares and plan.molecule_tokens.shape[0] == 1
    assert plan.suffix_start == shared
    assert t_auto == t_flat
    assert all(len(v) == 6 for v in t_auto.values())
    np.testing.assert_allclose(auto.logits.numpy(), flat.logits.numpy(),
                               rtol=0, atol=TOL)
    jauto = S.jengine(cache_len=length + 6, chunk=8, policy="auto")
    with pytest.raises((TypeError, ValueError)):
        _serve(jauto, prompts, 6, request=S.JRequest)


def test_a_second_decode_of_the_last_token_breaks_the_logits_check(S):
    """Fault 2: decoding the last prompt token twice (as the JAX shared
    path does) moves the next-token logits by well over the 1e-5 the
    test above allows."""
    prompts = np.stack(_prompts(5, 4, 30, 24))
    eng = Engine(S.model, cache_len=36, chunk=8, policy="auto", device="cpu")
    _, _, flat_logits = eng._prefill(torch.from_numpy(prompts))
    plan = eng._plan_prefixes(prompts)
    assert plan.shares
    _, cache, logits = eng._prefill_shared(prompts, plan)
    np.testing.assert_allclose(logits.numpy(), flat_logits.numpy(), rtol=0,
                               atol=TOL)
    pos = torch.full((4, 1), 29, dtype=torch.int32)
    _, _, twice = eng._decode(torch.from_numpy(prompts[:, -1:]), cache, pos)
    assert (twice - flat_logits).abs().max().item() > 10 * TOL


def test_measure_plans_but_serves_flat(S):
    prompts = _prompts(6, 4, 24, 16)
    flat = _serve(Engine(S.model, cache_len=28, chunk=8, policy="flat",
                         device="cpu"), prompts, 4)
    eng = Engine(S.model, cache_len=28, chunk=8, policy="measure",
                 device="cpu")
    assert _serve(eng, prompts, 4) == flat
    assert eng.last_plan is not None and eng.last_plan.shares
    assert eng.last_plan.savings_pct > 0


def test_policies_and_stats():
    assert PREFIX_POLICIES.names() == ("auto", "flat", "measure")
    cfg = t_reduced(t_get_arch("recurrentgemma-2b"), n_layers=3)
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    eng = Engine(model, cache_len=20, chunk=4, policy="auto", device="cpu")
    out = _serve(eng, _prompts(7, 3, 12, 8), 5)
    assert sorted(out) == [0, 1, 2] and all(len(v) == 5 for v in out.values())
    assert eng.stats["prefill_s"] > 0 and len(eng.stats["decode_s"]) == 4
    assert eng.logits is None
    with pytest.raises(KeyError):
        Engine(model, policy="nope", device="cpu")


# ---------------------------------------------------------------------------
# the KV pool, molecule_broadcast and temperature sampling
# ---------------------------------------------------------------------------

def test_kv_pool():
    """The JAX ``tests/test_serving.py::test_kv_pool`` on the port's pool:
    allocation, occupancy, a freed slot reused at once, exhaustion."""
    from repro_torch.serving.kv_cache import KVPool, SlotState
    pool = KVPool(3)
    a = pool.alloc(10)
    pool.alloc(11)
    assert pool.occupancy() == pytest.approx(2 / 3)
    pool.free(a)
    assert pool.slots[a] == SlotState()
    assert pool.alloc(12) == a         # slot reuse (continuous batching)
    pool.alloc(13)
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(14)
    assert sorted(pool.active()) == [0, 1, 2]
    assert pool.slots[a] == SlotState(12, 0)


def test_molecule_broadcast_equals_jax_after_unstacking():
    """The JAX ``molecule_broadcast`` over layer-stacked (L, B, ...) caches
    against the port's over per-layer (B, ...) ones: a prefix of 5 of 9
    KV positions, every other tensor whole."""
    jax = pytest.importorskip("jax")
    from repro.serving.kv_cache import molecule_broadcast as jmb
    from repro_torch.convert import unstack_layers
    from repro_torch.serving.kv_cache import molecule_broadcast
    rng = np.random.default_rng(3)
    n_l, b, m = 2, 4, 2

    def cache(batch, s):
        r = lambda *shape: rng.standard_normal(  # noqa: E731
            (n_l, batch) + shape).astype(np.float32)
        return {"attn": {"k": r(2, s, 8), "v": r(2, s, 8),
                         "pos": rng.integers(0, 50, (n_l, batch, s)).astype(
                             np.int32)},
                "rglru": {"state": r(6), "conv": r(3, 6)},
                "ssd": {"state": r(3, 4, 5)}}
    full, mol = cache(b, 9), cache(m, 5)
    inst = np.array([1, 0, 1, 1])
    want = jmb(jax.tree.map(jax.numpy.asarray, full),
               jax.tree.map(jax.numpy.asarray, mol), inst)
    tt = lambda tree: [jax.tree.map(torch.from_numpy, layer)  # noqa: E731
                       for layer in unstack_layers(tree, n_l)]
    tfull = tt(full)
    got = molecule_broadcast(tfull, tt(mol), inst)
    for i, (g, w) in enumerate(zip(got, unstack_layers(
            jax.tree.map(np.asarray, want), n_l))):
        for blk in w:
            for name in w[blk]:
                np.testing.assert_array_equal(g[blk][name].numpy(),
                                              w[blk][name], f"{i}.{blk}."
                                              f"{name}")
    np.testing.assert_array_equal(tfull[0]["attn"]["k"].numpy(),
                                  full["attn"]["k"][0])   # input untouched


def test_temperature_sampling_equals_jax_categorical(S):
    """A decode step at temperature T: the JAX step samples with
    ``jax.random.categorical(key, logits / T)``, which is
    ``argmax(logits / T + gumbel(key))``; the port, handed the same
    Gumbel noise, picks the same tokens.  At T -> 0 the port's own
    noise (from a ``torch.Generator``) leaves the greedy token."""
    from repro.train.serve_step import make_decode_step as jdecode
    from repro.train.serve_step import make_prefill_step as jprefill
    from repro_torch.train.serve_step import (gumbel_noise, make_decode_step,
                                              make_prefill_step)
    jax = S.jax
    toks = np.random.default_rng(5).integers(1, 512, (4, 12)).astype(
        np.int32)
    pos = np.full((4, 1), 12, np.int32)
    jnext, jcache = jax.jit(jprefill(S.jm, ctx=S.ctx, cache_len=16))(
        S.params, jax.numpy.asarray(toks))
    vocab = S.model.cfg.vocab_size
    for t, seed in ((0.7, 1), (1.5, 2), (1.5, 3)):
        key = jax.random.PRNGKey(seed)
        want, _ = jdecode(S.jm, ctx=S.ctx, temperature=t)(
            S.params, jnext[:, None], jcache, jax.numpy.asarray(pos),
            rng=key)
        noise = np.array(jax.random.gumbel(key, (4, vocab)))
        nxt, cache, _ = make_prefill_step(S.model, cache_len=16)(
            torch.from_numpy(toks))
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
        got, _, _ = make_decode_step(S.model, temperature=t)(
            nxt[:, None], cache, torch.from_numpy(pos),
            noise=torch.from_numpy(noise))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nxt, cache, _ = make_prefill_step(S.model, cache_len=16)(
        torch.from_numpy(toks))
    greedy, _, _ = make_decode_step(S.model)(nxt[:, None], cache,
                                             torch.from_numpy(pos))
    nxt, cache, _ = make_prefill_step(S.model, cache_len=16)(
        torch.from_numpy(toks))
    cold, _, _ = make_decode_step(S.model, temperature=1e-6)(
        nxt[:, None], cache, torch.from_numpy(pos),
        generator=torch.Generator().manual_seed(0))
    assert torch.equal(cold, greedy)
    g = gumbel_noise((200_000,), torch.Generator().manual_seed(1))
    assert abs(float(g.mean()) - 0.5772) < 0.01       # Euler's constant
    with pytest.raises(ValueError, match="generator or noise"):
        make_decode_step(S.model, temperature=1.0)(nxt[:, None], cache,
                                                   torch.from_numpy(pos))


def test_decode_input_specs_are_the_cache_specs():
    from repro_torch.train.serve_step import decode_input_specs
    cfg = t_reduced(t_get_arch("recurrentgemma-2b"))
    model = LM(cfg, device="cpu")
    specs = decode_input_specs(model, 3, 40)
    assert specs["tokens"].shape == specs["positions"].shape == (3, 1)
    assert specs["tokens"].dtype == "int32"
    assert specs["cache"] == model.cache_specs(3, 40)
    assert specs["cache"][2]["attn"]["k"].shape == (3, 1, 32, 32)


# ---------------------------------------------------------------------------
# the serve path on the card (runs only where a card is present)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["flat", "auto"])
def test_cuda_engine_matches_the_cpu_engine(cuda, policy):
    """The reduced config (head_dim 64: the flash kernel's smallest) in
    float32 on the card, through both kernels, against the plain path on
    the CPU: same tokens, logits within 1e-4 (float32 GEMMs and
    attention summed in another order)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    cfg = t_reduced(t_get_arch("recurrentgemma-2b"), head_dim=64)
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    gpu = LM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    prompts = _prompts(11, 4, 48, 40)
    before = (fa.launches, ls.launches)
    outs, logits = [], []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        eng = Engine(model, cache_len=54, chunk=8, policy=policy, device=dev)
        outs.append(_serve(eng, prompts, 6, keep_logits=True))
        logits.append(eng.logits.cpu())
    assert fa.launches > before[0]
    assert ls.launches > before[1]
    assert outs[0] == outs[1]
    np.testing.assert_allclose(logits[1].numpy(), logits[0].numpy(), rtol=0,
                               atol=1e-4)
