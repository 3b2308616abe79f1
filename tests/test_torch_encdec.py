"""repro_torch's encoder-decoder (whisper) and VLM stub against the JAX LM.

``reduced`` whisper-medium: 2 decoder layers (self-attention, then
cross-attention over the encoder's K/V, then an MLP) and 2 encoder
layers (non-causal attention + MLP) over 16 frame embeddings of width
128, learned positions (``rope_theta == 0``); ``reduced`` internvl2-2b: 2
dense GQA layers behind 16 patch embeddings of width 64 projected by
``frontend_proj`` and placed before the text.  d 128, 4 heads over 2 KV
heads of 32, float32.  The weights cross through
``convert.lm_params_from_jax`` (``encoder.layers`` and the decoder's
merged ``xattn`` leaves are layer-stacked in the JAX tree), every leaf
the JAX init leaves at zero redrawn from a numpy seed; the frontend
embeddings and the tokens are numpy-seeded too.  The JAX side runs its
Pallas kernels in interpret mode (at S = 16 its KV tile covers the
frames, so the unmasked zero padding of ROADMAP §3 item 1 does not
arise).

Tolerance: 1e-5 absolute on logits (scale ~1-3), caches, the encoder's
output and its K/V, as for the other stacks.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import lm_params_from_jax, unstack_layers
from repro_torch.models.lm import MAX_LEARNED_POS, LM
from repro_torch.serving import Engine
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from test_torch_dense import _tokens, jax_model

TOL = 1e-5
CACHE_LEN = 64
STUBS = ("whisper-medium", "internvl2-2b")


@pytest.fixture(scope="module", params=STUBS)
def M(request):
    pytest.importorskip("jax")
    m = jax_model(request.param, seed=30 + STUBS.index(request.param),
                  cache_len=CACHE_LEN)
    cfg = m.cfg
    m.frames = np.random.default_rng(40).standard_normal(
        (2, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model)).astype(
        np.float32)
    # the first text position's index in the sequence the layers see
    m.offset = cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0
    return m


def _jax_prefill(M, toks, frames):
    return M.prefill(M.params, M.jnp.asarray(toks),
                     frontend_embeds=M.jnp.asarray(frames))


def _port_prefill(M, toks, frames):
    return M.model.prefill(torch.from_numpy(toks), cache_len=CACHE_LEN,
                           frontend_embeds=torch.from_numpy(frames))


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=TOL, err_msg=what)


def assert_cache_close(M, jcache, tcache):
    """The JAX cache (layer-stacked ``layers``, and an encoder-decoder's
    stacked ``encoder_kv``) against the port's per-layer list, whose
    layers carry the encoder K/V under ``xattn``."""
    layers = unstack_layers(jcache["layers"], M.cfg.n_layers)
    if "encoder_kv" in jcache:
        enc = unstack_layers(jcache["encoder_kv"], M.cfg.n_layers)
        layers = [{**lay, "xattn": kv} for lay, kv in zip(layers, enc)]
    assert len(layers) == len(tcache)
    for i, (jl, tl) in enumerate(zip(layers, tcache)):
        assert set(jl) == set(tl)
        for blk in jl:
            assert set(jl[blk]) == set(tl[blk])
            for name, want in jl[blk].items():
                _close(tl[blk][name], want, f"{i}.{blk}.{name}")


@pytest.mark.parametrize("t", [12, 40])
def test_prefill_logits_and_caches_match_jax(M, t):
    toks = _tokens(t, 2, t)
    jl, jc = _jax_prefill(M, toks, M.frames)
    tl, tc = _port_prefill(M, toks, M.frames)
    assert tuple(tl.shape) == (2, 1, M.cfg.vocab_size)
    _close(tl, jl)
    assert_cache_close(M, jc, tc)
    assert ("xattn" in tc[0]) == bool(M.cfg.encoder_layers)


def test_decode_steps_match_jax(M):
    """Decode steps continue at position ``offset + T`` (after the
    image tokens in the VLM), reading the encoder K/V from the cache."""
    t, steps = 20, 4
    toks = _tokens(t, 2, t)
    _, jc = _jax_prefill(M, toks, M.frames)
    _, tc = _port_prefill(M, toks, M.frames)
    nxt = _tokens(t + 1, 2, steps)
    for i in range(steps):
        pos = np.full((2, 1), M.offset + t + i, np.int32)
        jl, jc = M.decode(M.params, M.jnp.asarray(nxt[:, i:i + 1]), jc,
                          M.jnp.asarray(pos))
        tl, tc = M.model.decode_step(torch.from_numpy(nxt[:, i:i + 1]), tc,
                                     torch.from_numpy(pos))
        _close(tl, jl, f"step {i}")
    assert_cache_close(M, jc, tc)


def test_decode_after_prefill_equals_full_prefill(M):
    """Prefill T, decode token T+1 at position ``offset + T``: the
    logits of a prefill of T + 1 tokens (JAX and port), as chip_smoke
    phase 7e checks at full width."""
    toks = _tokens(10, 2, 30)
    full, _ = _jax_prefill(M, toks, M.frames)
    _, tc = _port_prefill(M, toks[:, :29], M.frames)
    pos = np.full((2, 1), M.offset + 29, np.int32)
    tdec, _ = M.model.decode_step(torch.from_numpy(toks[:, 29:]), tc,
                                  torch.from_numpy(pos))
    _close(tdec, full)
    tfull, _ = _port_prefill(M, toks, M.frames)
    _close(tdec, tfull)


def test_serve_steps_take_frontend_embeds(M):
    """``make_prefill_step``/``make_decode_step`` with ``frontend_embeds``
    give the JAX serve steps' greedy tokens."""
    import jax
    from repro.train.serve_step import make_decode_step as jdec
    from repro.train.serve_step import make_prefill_step as jpre
    toks = _tokens(7, 2, 16)
    jp = jax.jit(jpre(M.jm, ctx=M.ctx, cache_len=CACHE_LEN))
    jd = jax.jit(jdec(M.jm, ctx=M.ctx))
    tp = make_prefill_step(M.model, cache_len=CACHE_LEN)
    td = make_decode_step(M.model)
    jn, jc = jp(M.params, M.jnp.asarray(toks), M.jnp.asarray(M.frames))
    tn, tc, _ = tp(torch.from_numpy(toks), torch.from_numpy(M.frames))
    got, want = [tn.tolist()], [np.asarray(jn).tolist()]
    for i in range(3):
        pos = np.full((2, 1), M.offset + 16 + i, np.int32)
        jn, jc = jd(M.params, M.jnp.asarray(want[-1])[:, None], jc,
                    M.jnp.asarray(pos))
        tn, tc, _ = td(torch.tensor(got[-1])[:, None], tc,
                       torch.from_numpy(pos))
        got.append(tn.tolist())
        want.append(np.asarray(jn).tolist())
    assert got == want


def test_prefill_needs_frontend_embeds(M):
    with pytest.raises(ValueError, match="frontend_embeds"):
        M.model.prefill(torch.from_numpy(_tokens(1, 2, 8)),
                        cache_len=CACHE_LEN)


def test_engine_refuses_a_frontend_config(M):
    """The JAX ``Engine`` prefills without ``frontend_embeds`` and fails
    inside the encoder or the stub's projection (ROADMAP §3 item 10);
    the port's refuses the config up front and names ``serve_step``."""
    with pytest.raises(ValueError, match="serve_step"):
        Engine(M.model, cache_len=CACHE_LEN, device="cpu")


def test_lm_params_from_jax_unstacks_encoder_and_xattn(M):
    sd = lm_params_from_jax(M.tcfg, M.tree)
    assert set(sd) == set(LM.param_specs(M.tcfg))
    if M.cfg.encoder_layers:
        enc = M.tree["encoder"]
        assert isinstance(enc["layers"], dict)
        for i in range(M.cfg.encoder_layers):
            for blk, d in enc["layers"].items():
                for name, leaf in d.items():
                    np.testing.assert_array_equal(
                        sd[f"encoder.layers.{i}.{blk}.{name}"], leaf[i])
        for i in range(M.cfg.n_layers):
            np.testing.assert_array_equal(
                sd[f"layers.{i}.xattn.wq"],
                M.tree["layers"]["xattn"]["wq"][i])
        np.testing.assert_array_equal(sd["encoder.in_proj"], enc["in_proj"])
        assert sd["pos_embed"].shape == (MAX_LEARNED_POS, M.cfg.d_model)
    else:
        np.testing.assert_array_equal(sd["frontend_proj"],
                                      M.tree["frontend_proj"])
        assert not any(k.startswith("encoder.") or ".xattn." in k
                       for k in sd)


# ---------------------------------------------------------------------------
# whisper's parts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def W():
    pytest.importorskip("jax")
    return jax_model("whisper-medium", seed=32, cache_len=CACHE_LEN)


def test_encoder_output_matches_jax(W):
    """The encoder alone (in_proj, its learned positions, 2 non-causal
    layers, final norm) over the same frames."""
    frames = np.random.default_rng(41).standard_normal(
        (3, W.cfg.frontend_tokens, W.cfg.d_model)).astype(np.float32)
    want = W.jm.encode(W.ctx, W.params, W.jnp.asarray(frames))
    got = W.model.encoder(W.model.ctx, torch.from_numpy(frames),
                          W.model.dtype)
    _close(got, want)


def test_encoder_kv_matches_jax(W):
    """Each decoder layer's cross-attention K/V of the encoder output,
    (B, Hkv, S, hd), no rope."""
    frames = np.random.default_rng(42).standard_normal(
        (2, W.cfg.frontend_tokens, W.cfg.d_model)).astype(np.float32)
    enc = W.jm.encode(W.ctx, W.params, W.jnp.asarray(frames))
    want = unstack_layers(W.jm._encoder_kv(W.params, enc), W.cfg.n_layers)
    tenc = torch.from_numpy(np.array(enc))
    for i, layer in enumerate(W.model.layers):
        got = layer.xattn.encoder_kv(tenc)
        assert tuple(got["k"].shape) == (2, W.cfg.n_kv_heads,
                                         W.cfg.frontend_tokens,
                                         W.cfg.resolved_head_dim)
        for name in ("k", "v"):
            _close(got[name], want[i][name], f"{i}.{name}")


def test_learned_positions_match_jax(W):
    """``_embed`` adds ``pos_embed`` at each token's position: the JAX
    ``_embed`` at positions 0.., and at scattered later positions."""
    toks = _tokens(3, 2, 9)
    for pos in (np.tile(np.arange(9, dtype=np.int32), (2, 1)),
                np.random.default_rng(43).integers(
                    0, MAX_LEARNED_POS, (2, 9)).astype(np.int32)):
        want = W.jm._embed(W.params, W.jnp.asarray(toks), W.jnp.asarray(pos))
        got = W.model._embed(torch.from_numpy(toks), torch.from_numpy(pos))
        _close(got, want)
    plain = W.model.embed[torch.from_numpy(toks).long()] * \
        W.cfg.d_model ** 0.5
    assert float((got - plain).abs().max()) > 1e-3


@pytest.fixture(scope="module")
def V():
    pytest.importorskip("jax")
    return jax_model("internvl2-2b", seed=33, cache_len=CACHE_LEN)


def test_image_tokens_take_the_first_positions(V):
    """The P projected patches sit at positions 0..P-1 and the text at
    P..P+T-1: a prefill of the text alone after the image equals the
    JAX prefill, and moving the image after the text (as positions
    would if the offset were lost) changes the logits."""
    frames = np.random.default_rng(44).standard_normal(
        (2, V.cfg.frontend_tokens, V.cfg.frontend_dim)).astype(np.float32)
    toks = _tokens(5, 2, 10)
    _, tc = V.model.prefill(torch.from_numpy(toks), cache_len=CACHE_LEN,
                            frontend_embeds=torch.from_numpy(frames))
    p = V.cfg.frontend_tokens
    np.testing.assert_array_equal(tc[0]["attn"]["pos"][:, :p + 10].numpy(),
                                  np.broadcast_to(np.arange(p + 10), (2, p +
                                                                      10)))
    jl, _ = V.prefill(V.params, V.jnp.asarray(toks),
                      frontend_embeds=V.jnp.asarray(frames))
    tl, _ = V.model.prefill(torch.from_numpy(toks), cache_len=CACHE_LEN,
                            frontend_embeds=torch.from_numpy(frames))
    _close(tl, jl)
    other = np.random.default_rng(45).standard_normal(frames.shape).astype(
        np.float32)
    ol, _ = V.model.prefill(torch.from_numpy(toks), cache_len=CACHE_LEN,
                            frontend_embeds=torch.from_numpy(other))
    assert float((ol - tl).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", STUBS)
def test_cuda_serve_steps_match_the_cpu(cuda, name):
    """The reduced config at head_dim 64 in float32 on the card (flash
    as its CUDA-core kernel: whisper's encoder and cross-attention
    non-causal) against the CPU: same tokens, logits within 1e-4."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import flash_attention as fa
    cfg = reduced(get_arch(name), head_dim=64)
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    gpu = LM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(46)
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model)).astype(
        np.float32))
    toks = torch.from_numpy(_tokens(8, 2, 20))
    before = fa.cuda_core_launches
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        _, cache, logits = make_prefill_step(model, cache_len=CACHE_LEN)(
            toks.to(dev), frames.to(dev))
        outs.append(logits.cpu())
    assert fa.cuda_core_launches > before
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), rtol=0,
                               atol=1e-4)

