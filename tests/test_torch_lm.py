"""repro_torch's recurrentgemma LM against the JAX model.

``reduced(get_arch("recurrentgemma-2b"))``: 3 layers (rglru, rglru,
local), d 128, 4 heads over 2 KV heads, window 32, float32.  The JAX
weights cross through ``convert.lm_params_from_jax``; the JAX side runs
its Pallas kernels in interpret mode (``Ctx(attn_impl=
"pallas_interpret", scan_impl="pallas_interpret")``).

Tolerance: 1e-5 absolute on logits (scale ~2.6) and caches -- float32
on both sides, differing in summation order only (measured ~7e-7).

Fault 3 of the JAX serving path (``blocks.attn_prefill_cache`` lays a
window-sized cache out in order, so after a prefill of t > window with
t % window != 0 the first decode overwrites a key still inside the
window) is pinned both ways: the port's decode-after-prefill equals the
JAX *full* prefill, the JAX decode-after-prefill does not.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import common
from repro_torch.models.lm import LM

TOL = 1e-5
CACHE_LEN = 48          # > window: the local layers keep a 32-slot ring


@pytest.fixture(scope="module")
def M():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch, reduced
    from repro.models.blocks import Ctx
    from repro.models.lm import LM as JLM

    cfg = reduced(get_arch("recurrentgemma-2b"))
    tcfg = t_reduced(t_get_arch("recurrentgemma-2b"))
    jm = JLM(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = LM(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(
        tcfg, jax.tree.map(np.asarray, params)))
    ctx = Ctx(cfg=cfg, attn_impl="pallas_interpret",
              scan_impl="pallas_interpret")
    prefill = jax.jit(functools.partial(jm.prefill, ctx=ctx,
                                        cache_len=CACHE_LEN))
    decode = jax.jit(functools.partial(jm.decode_step, ctx=ctx))
    return types.SimpleNamespace(jax=jax, jnp=jnp, cfg=cfg, tcfg=tcfg,
                                 params=params, model=model,
                                 prefill=prefill, decode=decode)


def _tokens(seed, b, t):
    return np.random.default_rng(seed).integers(1, 512, (b, t)).astype(
        np.int32)


def _np(x):
    return np.asarray(x, dtype=np.float64)


def _assert_cache_close(jcache, tcache):
    assert len(jcache["layers"]) == len(tcache)
    for jl, tl in zip(jcache["layers"], tcache):
        assert set(jl) == set(tl)
        for blk in jl:
            for name, want in jl[blk].items():
                np.testing.assert_allclose(_np(tl[blk][name]), _np(want),
                                           rtol=0, atol=TOL,
                                           err_msg=f"{blk}.{name}")


def test_norm_and_rope_match_jax(M):
    from repro.models import common as jcommon
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0) + 7
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jcommon.rms_norm(M.jnp.asarray(x), M.jnp.asarray(w))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        common.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(jcommon.rope(M.jnp.asarray(x), M.jnp.asarray(pos), 1e4)),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("t", [20, 32])
def test_prefill_logits_and_caches_match_jax(M, t):
    toks = _tokens(t, 2, t)
    jl, jc = M.prefill(M.params, M.jnp.asarray(toks))
    tl, tc = M.model.prefill(torch.from_numpy(toks), cache_len=CACHE_LEN)
    assert tuple(tl.shape) == (2, 1, M.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    _assert_cache_close(jc, tc)


def test_prefill_beyond_window_keeps_position_p_in_slot_p_mod_s(M):
    """t = 39 > window 32: logits and recurrent states match JAX; the
    ring buffer holds JAX's last 32 keys, position p in slot p % 32."""
    t, s = 39, 32
    toks = _tokens(t, 2, t)
    jl, jc = M.prefill(M.params, M.jnp.asarray(toks))
    tl, tc = M.model.prefill(torch.from_numpy(toks), cache_len=CACHE_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    for jlay, tlay in zip(jc["layers"], tc):
        if "rglru" in jlay:
            _assert_cache_close({"layers": [jlay]}, [tlay])
            continue
        slots = np.arange(t - s, t) % s
        for name in ("k", "v", "pos"):
            want = _np(jlay["attn"][name])                  # in order
            got = _np(tlay["attn"][name])
            np.testing.assert_allclose(got[..., slots, :] if name != "pos"
                                       else got[:, slots], want, rtol=0,
                                       atol=TOL)


def test_decode_steps_match_jax(M):
    toks = _tokens(1, 2, 20)
    _, jc = M.prefill(M.params, M.jnp.asarray(toks))
    _, tc = M.model.prefill(torch.from_numpy(toks), cache_len=CACHE_LEN)
    nxt = _tokens(2, 2, 3)
    for i in range(3):
        pos = np.full((2, 1), 20 + i, np.int32)
        jl, jc = M.decode(M.params, M.jnp.asarray(nxt[:, i:i + 1]), jc,
                          M.jnp.asarray(pos))
        tl, tc = M.model.decode_step(torch.from_numpy(nxt[:, i:i + 1]), tc,
                                     torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)
    _assert_cache_close(jc, tc)


def test_decode_after_prefill_beyond_window_equals_full_prefill(M):
    """Fault 3, pinned both ways: prefill 39 tokens (39 % 32 != 0), decode
    the 40th; the port equals the JAX full prefill of 40 tokens, the JAX
    decode-after-prefill departs from it."""
    toks = _tokens(9, 2, 40)
    full, _ = M.prefill(M.params, M.jnp.asarray(toks))
    pos = np.full((2, 1), 39, np.int32)
    _, jc = M.prefill(M.params, M.jnp.asarray(toks[:, :39]))
    jdec, _ = M.decode(M.params, M.jnp.asarray(toks[:, 39:]), jc,
                       M.jnp.asarray(pos))
    _, tc = M.model.prefill(torch.from_numpy(toks[:, :39]),
                            cache_len=CACHE_LEN)
    tdec, _ = M.model.decode_step(torch.from_numpy(toks[:, 39:]), tc,
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(tdec.numpy(), np.asarray(full), rtol=0,
                               atol=TOL)
    assert np.abs(np.asarray(jdec) - np.asarray(full)).max() > 5e-4


def test_decode_within_window_matches_jax_full_prefill(M):
    """The same check at t = 29 (no wrap): both paths equal the full
    prefill."""
    toks = _tokens(10, 2, 30)
    full, _ = M.prefill(M.params, M.jnp.asarray(toks))
    pos = np.full((2, 1), 29, np.int32)
    _, jc = M.prefill(M.params, M.jnp.asarray(toks[:, :29]))
    jdec, _ = M.decode(M.params, M.jnp.asarray(toks[:, 29:]), jc,
                       M.jnp.asarray(pos))
    _, tc = M.model.prefill(torch.from_numpy(toks[:, :29]),
                            cache_len=CACHE_LEN)
    tdec, _ = M.model.decode_step(torch.from_numpy(toks[:, 29:]), tc,
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(tdec.numpy(), np.asarray(full), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(np.asarray(jdec), np.asarray(full), rtol=0,
                               atol=TOL)


def test_generator_init_is_seeded_and_follows_the_specs():
    cfg = t_reduced(t_get_arch("recurrentgemma-2b"))
    a = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (name, pa), (_, pb) in zip(a.state_dict().items(),
                                   b.state_dict().items()):
        assert torch.equal(pa, pb), name
    sd = a.state_dict()
    assert torch.all(sd["final_ln"] == 0) and torch.all(
        sd["layers.0.rglru.lam"] == 1)
    assert 0.015 < float(sd["embed"].std()) < 0.025
    assert 0.007 < float(sd["layers.2.attn.wo"].std()) < 0.013
    assert set(sd) == set(LM.param_specs(cfg))


def test_unported_configs_raise_not_implemented():
    """What the port still refuses: MoE, the whisper encoder, the vision
    stub, learned positions, an unknown layer kind (the dense and SSM
    stacks it refused before now run: ``test_torch_dense.py``,
    ``test_torch_ssd.py``)."""
    cfg = t_reduced(t_get_arch("recurrentgemma-2b"))
    dense = t_reduced(t_get_arch("qwen2-0.5b"))
    for bad in (dataclasses.replace(dense, family="moe", n_experts=4,
                                    experts_per_token=2),
                dataclasses.replace(dense, family="audio", encoder_layers=2,
                                    frontend="audio_stub", rope_theta=0.0),
                dataclasses.replace(dense, family="vlm",
                                    frontend="vision_stub"),
                dataclasses.replace(dense, rope_theta=0.0),
                dataclasses.replace(cfg, layer_pattern=("moe", "local"))):
        with pytest.raises(NotImplementedError):
            LM(bad, device="cpu")
        with pytest.raises(NotImplementedError):
            LM.param_specs(bad)
    for ok in (dataclasses.replace(cfg, family="dense", layer_pattern=()),
               dataclasses.replace(cfg, layer_pattern=("ssd", "local"),
                                   ssm_state=16, ssm_head_dim=32,
                                   ssm_chunk=16)):
        LM(ok, device="cpu")


def test_lm_params_from_jax_rejects_foreign_trees():
    cfg = t_reduced(t_get_arch("recurrentgemma-2b"))
    specs = LM.param_specs(cfg)
    tree = {"embed": np.zeros(specs["embed"].shape, np.float32),
            "final_ln": np.zeros(specs["final_ln"].shape, np.float32)}
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_jax(cfg, tree)


def test_lm_params_from_jax_carries_bf16_bits(M):
    """A bf16 JAX tree (ml_dtypes leaves) crosses bit for bit."""
    from repro.configs import get_arch, reduced
    from repro.models.lm import LM as JLM
    cfg = reduced(get_arch("recurrentgemma-2b"), dtype="bfloat16",
                  param_dtype="bfloat16")
    tcfg = t_reduced(t_get_arch("recurrentgemma-2b"), dtype="bfloat16",
                     param_dtype="bfloat16")
    tree = M.jax.tree.map(np.asarray, JLM(cfg).init(M.jax.random.PRNGKey(2)))
    sd = lm_params_from_jax(tcfg, tree)
    want = tree["layers"][2]["attn"]["wq"]
    got = sd["layers.2.attn.wq"]
    assert got.dtype == torch.bfloat16 and want.dtype.name == "bfloat16"
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    model = LM(tcfg, device="cpu")
    model.load_state_dict(sd)
    assert model.layers[0].rglru.conv.dtype == torch.float32
