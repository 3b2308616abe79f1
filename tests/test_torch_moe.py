"""repro_torch's MoE against the JAX package's.

The block alone: a ``reduced`` dbrx-132b MoE (d 32, per-expert hidden
16) at 4 to 64 experts and top-2 to top-6, weights and inputs drawn from
a numpy seed, float32 on both sides.  The router (float32 logits,
softmax, top-k, renormalised weights, the Switch-style ``aux``) must
pick the same experts in the same order, its weights and ``aux`` within
1e-6; the ``ragged`` dropless path within 1e-5 of the JAX
``jax.lax.ragged_dot`` one, on both of its routes (every expert on
every token up to ``MOE_DENSE_TOKENS`` tokens, the expert-sorted rows
above).  The port's ``shard_map`` path is
single-controller over a mesh of CPU entries: at capacity factor
``n_experts`` (nothing dropped) it equals the ragged path, as the JAX
``tests/test_moe.py`` holds the JAX pair on a (1, 1) mesh; at a tight
capacity it drops the same slots as the JAX ``_moe_shard_map``.

The stacks: ``reduced`` moonshot-v1-16b-a3b and dbrx-132b (2 layers of
attention + MoE, d 128, 4 heads over 2 KV heads of 32, 4 experts top-2,
float32) through ``jax_model`` (``test_torch_dense.py``: the JAX tree,
whose expert weights are layer-stacked ``(L, E, d, f)``, unstacked by
``convert.lm_params_from_jax``; every zero-initialised leaf redrawn), the
JAX Pallas kernels in interpret mode.  Tolerance 1e-5 on logits and
caches, as for the dense stacks.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import lm_params_from_jax
from repro_torch.dist.mesh import make_test_mesh
from repro_torch.models import blocks
from repro_torch.models.lm import LM
from repro_torch.serving import Engine
from test_torch_dense import (_prompts, _serve, _tokens, assert_cache_close,
                              cuda_matches_cpu, jax_model)

TOL = 1e-5
TOL_ROUTER = 1e-6
CACHE_LEN = 48
MOE = ("moonshot-v1-16b-a3b", "dbrx-132b")
# (experts, top-k): the reduced configs' 4/2, dbrx's 16/4, moonshot's 64/6
ROUTES = [(4, 2), (8, 2), (16, 4), (64, 6)]


def _setup(e=4, k=2, d=32, f=16, seed=0, b=2, t=8):
    """The JAX and port configs of one MoE block, its numpy weights (the
    JAX ``moe_specs`` names) and a (b, t, d) input."""
    from repro.configs import get_arch, reduced
    kw = dict(d_model=d, moe_d_ff=f, n_experts=e, experts_per_token=k,
              n_heads=2, n_kv_heads=1, head_dim=16)
    cfg = reduced(get_arch("dbrx-132b"), **kw)
    tcfg = t_reduced(t_get_arch("dbrx-132b"), **kw)
    rng = np.random.default_rng(seed)
    p = {name: (rng.standard_normal(s.shape) * 0.3).astype(np.float32)
         for name, s in blocks.moe_specs(tcfg).items()}
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    return cfg, tcfg, p, x


def _port_block(tcfg, p) -> blocks.MoE:
    m = blocks.MoE(tcfg, torch.device("cpu"))
    m.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    return m


def _jax_moe(cfg, p, x, **ctx):
    import jax
    import jax.numpy as jnp
    from repro.models import blocks as jblocks
    from repro.models.blocks import Ctx as JCtx
    c = JCtx(cfg=cfg, **ctx)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    if "mesh" in ctx:
        with ctx["mesh"]:
            o, a = jax.jit(lambda p_, x_: jblocks.moe_apply(c, p_, x_))(
                pj, jnp.asarray(x))
    else:
        o, a = jblocks.moe_apply(c, pj, jnp.asarray(x))
    return np.asarray(o), float(a)



@pytest.fixture(autouse=True)
def _no_grad():
    """The blocks run here as the serve path runs them, recording no
    gradient (the port's parameters are trainable)."""
    with torch.no_grad():
        yield

@pytest.fixture(scope="module", autouse=True)
def _jax():
    pytest.importorskip("jax")


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,k", ROUTES, ids=str)
def test_router_matches_jax(e, k):
    """Same experts in the same order (``torch.topk(sorted=True)`` as
    ``jax.lax.top_k``), weights and aux within 1e-6.  The smallest gap
    between a token's k-th and (k+1)-th probability is printed: a tie
    there could part the two picks, and none occurs at these seeds."""
    import jax.numpy as jnp
    from repro.models import blocks as jblocks
    cfg, tcfg, p, x = _setup(e, k, seed=e + k, t=24)
    xf = x.reshape(-1, x.shape[-1])
    jw, je, ja = jblocks._router(cfg, {"router": jnp.asarray(p["router"])},
                                 jnp.asarray(xf))
    tw, te, ta = blocks.router(tcfg, torch.from_numpy(p["router"]),
                               torch.from_numpy(xf))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=TOL_ROUTER)
    assert abs(float(ta) - float(ja)) <= TOL_ROUTER
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)
    probs = torch.softmax(torch.from_numpy(xf) @ torch.from_numpy(
        p["router"]), -1).sort(-1, descending=True).values
    margin = float((probs[:, k - 1] - probs[:, k]).min())
    print(f"e={e} k={k}: smallest top-k margin {margin:.3g}")
    assert margin > 1e-6


@pytest.mark.parametrize("b,t", [(2, 8), (4, 40)], ids=["dense", "sorted"])
@pytest.mark.parametrize("e,k", ROUTES, ids=str)
def test_ragged_moe_matches_jax(e, k, b, t):
    """16 tokens take the every-expert path (``MOE_DENSE_TOKENS``), 160
    the expert-sorted one; both give the JAX ``ragged_dot`` output."""
    cfg, tcfg, p, x = _setup(e, k, seed=10 + e, b=b, t=t)
    assert (b * t <= blocks.MOE_DENSE_TOKENS) == (t == 8)
    want, waux = _jax_moe(cfg, p, x)
    got, aux = _port_block(tcfg, p)(blocks.Ctx(cfg=tcfg),
                                    torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert abs(float(aux) - waux) <= TOL_ROUTER


def test_ragged_moe_skips_empty_experts():
    """64 experts, 65 tokens x top-2 on the expert-sorted path: some
    experts get no row; the output still equals the JAX one."""
    cfg, tcfg, p, x = _setup(64, 2, seed=3, b=1, t=65)
    xt = torch.from_numpy(x)
    _, tope, _ = blocks.router(tcfg, torch.from_numpy(p["router"]),
                               xt.reshape(-1, tcfg.d_model))
    assert 65 > blocks.MOE_DENSE_TOKENS and len(tope.unique()) < 64
    want, _ = _jax_moe(cfg, p, x)
    got, _ = _port_block(tcfg, p)(blocks.Ctx(cfg=tcfg), xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("t", [1, 8, 64, 65, 200])
def test_dense_and_sorted_paths_agree(t, monkeypatch):
    """The every-expert path and the expert-sorted one on the same
    tokens, below, at and above the threshold: within 1e-5."""
    _, tcfg, p, x = _setup(16, 4, seed=13, b=1, t=t)
    m, xt = _port_block(tcfg, p), torch.from_numpy(x)
    outs = []
    for limit in (10**9, 0):          # every expert / expert-sorted
        monkeypatch.setattr(blocks, "MOE_DENSE_TOKENS", limit)
        outs.append(m(blocks.Ctx(cfg=tcfg), xt)[0])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2), (1, 4)], ids=str)
def test_shard_map_equals_ragged_without_drops(shape):
    """At capacity factor ``n_experts`` nothing overflows: the sum over
    the model axis's local experts is the dropless output (the JAX
    ``test_shard_map_matches_ragged``, here also on 2 and 4 model
    entries and 2 batch shards)."""
    cfg, tcfg, p, x = _setup(8, 2, seed=7, b=4)
    m = _port_block(tcfg, p)
    mesh = make_test_mesh(shape, ("data", "model"))
    xt = torch.from_numpy(x)
    want, waux = m(blocks.Ctx(cfg=tcfg), xt)
    got, aux = m(blocks.Ctx(cfg=tcfg, moe_impl="shard_map", mesh=mesh,
                            moe_capacity_factor=float(tcfg.n_experts)), xt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    if shape[0] == 1:
        assert abs(float(aux) - float(waux)) <= TOL_ROUTER


@pytest.mark.parametrize("factor", [0.5, 1.0, 4.0])
def test_shard_map_drops_what_jax_drops(factor):
    """A (1, 1) mesh at a tight capacity: the same slots dropped as in
    the JAX ``_moe_shard_map``, the output within 1e-5."""
    from repro.launch.mesh import make_test_mesh as jmesh
    cfg, tcfg, p, x = _setup(4, 2, seed=11)
    want, waux = _jax_moe(cfg, p, x, moe_impl="shard_map",
                          mesh=jmesh((1, 1), ("data", "model")),
                          moe_capacity_factor=factor)
    got, aux = _port_block(tcfg, p)(
        blocks.Ctx(cfg=tcfg, moe_impl="shard_map",
                   mesh=make_test_mesh((1, 1), ("data", "model")),
                   moe_capacity_factor=factor), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert abs(float(aux) - waux) <= TOL_ROUTER


def test_capacity_drops_stay_finite():
    """Capacity factor 0.5 drops slots: the output stays finite and
    departs from the dropless one (a dropped slot adds nothing)."""
    cfg, tcfg, p, x = _setup(4, 2, seed=12)
    m = _port_block(tcfg, p)
    xt = torch.from_numpy(x)
    full, _ = m(blocks.Ctx(cfg=tcfg), xt)
    tight, _ = m(blocks.Ctx(cfg=tcfg, moe_impl="shard_map",
                            mesh=make_test_mesh((1, 1), ("data", "model")),
                            moe_capacity_factor=0.5), xt)
    assert bool(torch.isfinite(tight).all())
    assert float((tight - full).abs().max()) > 1e-3


def test_moe_impl_is_checked():
    _, tcfg, p, x = _setup()
    m = _port_block(tcfg, p)
    with pytest.raises(ValueError, match="mesh"):
        m(blocks.Ctx(cfg=tcfg, moe_impl="shard_map"), torch.from_numpy(x))
    with pytest.raises(ValueError, match="moe_impl"):
        m(blocks.Ctx(cfg=tcfg, moe_impl="megablox"), torch.from_numpy(x))
    with pytest.raises(ValueError, match="divide"):
        m(blocks.Ctx(cfg=tcfg, moe_impl="shard_map",
                     mesh=make_test_mesh((1, 3), ("data", "model"))),
          torch.from_numpy(x))


# ---------------------------------------------------------------------------
# the stacks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE)
def M(request):
    return jax_model(request.param, seed=20 + MOE.index(request.param))


@pytest.mark.parametrize("t", [20, 48, 56])
def test_prefill_logits_and_caches_match_jax(M, t):
    toks = _tokens(t, 2, t)
    jl, jc = M.prefill(M.params, M.jnp.asarray(toks))
    tl, tc = M.model.prefill(torch.from_numpy(toks), cache_len=CACHE_LEN)
    assert tuple(tl.shape) == (2, 1, M.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    assert_cache_close(M.cfg, jc, tc)


@pytest.mark.parametrize("prompt,steps", [(20, 3), (46, 4)])
def test_decode_steps_match_jax(M, prompt, steps):
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
    toks = _tokens(10, 2, 30)
    full, _ = M.prefill(M.params, M.jnp.asarray(toks))
    _, tc = M.model.prefill(torch.from_numpy(toks[:, :29]),
                            cache_len=CACHE_LEN)
    tdec, _ = M.model.decode_step(torch.from_numpy(toks[:, 29:]), tc,
                                  torch.from_numpy(np.full((2, 1), 29,
                                                           np.int32)))
    np.testing.assert_allclose(tdec.numpy(), np.asarray(full), rtol=0,
                               atol=TOL)


def test_flat_tokens_equal_jax(M):
    """4 requests of 40 tokens sharing 32, 6 new, ``flat``."""
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    prompts = _prompts(5, 4, 40, 32)
    got = _serve(Engine(M.model, cache_len=46, chunk=8, policy="flat",
                        device="cpu"), prompts, 6)
    want = _serve(JEngine(M.jm, M.params, cache_len=46, chunk=8, ctx=M.ctx,
                          policy="flat"), prompts, 6, request=JRequest)
    assert got == want


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


def test_lm_params_from_jax_unstacks_the_expert_weights(M):
    """The JAX expert leaves are ``(L, E, d, f)``; layer i's are
    ``layers.<i>.moe.w_gate`` ``(E, d, f)``."""
    sd = lm_params_from_jax(M.tcfg, M.tree)
    assert set(sd) == set(LM.param_specs(M.tcfg))
    moe = M.tree["layers"]["moe"]
    e, f = M.cfg.n_experts, M.cfg.moe_d_ff
    assert moe["w_gate"].shape == (M.cfg.n_layers, e, M.cfg.d_model, f)
    for i in range(M.cfg.n_layers):
        for name, leaf in moe.items():
            np.testing.assert_array_equal(sd[f"layers.{i}.moe.{name}"],
                                          leaf[i])
    assert not any(".mlp." in name for name in sd)


def test_lm_shard_map_equals_ragged(M):
    """The whole stack with ``moe_impl="shard_map"`` on a (1, 2) mesh at
    capacity factor ``n_experts``: the ragged logits."""
    toks = torch.from_numpy(_tokens(4, 2, 20))
    sm = LM(M.tcfg, device="cpu", moe_impl="shard_map",
            mesh=make_test_mesh((1, 2), ("data", "model")),
            moe_capacity_factor=float(M.tcfg.n_experts))
    sm.load_state_dict(M.model.state_dict())
    want, wc = M.model.prefill(toks, cache_len=CACHE_LEN)
    got, gc = sm.prefill(toks, cache_len=CACHE_LEN)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    pos = torch.full((2, 1), 20, dtype=torch.int32)
    nxt = torch.from_numpy(_tokens(5, 2, 1))
    np.testing.assert_allclose(sm.decode_step(nxt, gc, pos)[0].numpy(),
                               M.model.decode_step(nxt, wc, pos)[0].numpy(),
                               rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", MOE)
def test_cuda_engine_matches_the_cpu_engine(cuda, name):
    """The reduced MoE stack at head_dim 64 in float32 on the card
    (flash as its CUDA-core kernel) against the CPU: same tokens."""
    from repro_torch.kernels import flash_attention as fa
    cuda_matches_cpu(cuda, name, "flat", lambda: fa.cuda_core_launches)

