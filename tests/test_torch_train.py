"""repro_torch's training path against the JAX package's, on the CPU.

Every module of the slice on the same numpy-seeded inputs, float32,
reduced configs: the fused cross-entropy and its gradient;
``chunked_attention`` forward and VJP (GQA groups 1-4, causal or not,
windows, T < S) and the flash wrapper's row LSE; the linear scan's
gradients; AdamW and Adafactor over three steps (weight decay,
factoring and update clipping decided per JAX leaf, layer-stacked
ones included); one train step of every family (loss, ``aux``, every
gradient, the new parameters); gradient accumulation; the data
pipeline; the int8 codec; checkpoints and the ``launch.train`` losses.

Tolerance: 1e-5 absolute (float32 on both sides, differing in
summation order only), 1e-6 on the loss values; integer results
(tokens, int8 codes) exactly.  The JAX side runs its default XLA paths
(``mha_ref`` below 1k keys, ``linear_scan_ref``), whose gradients
``jax.grad`` derives.  Checkpoint directories come from ``tempfile``.
"""
import dataclasses
import functools
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import (_flatten, jax_leaves, lm_params_from_jax,
                                 train_state_from_jax)
from repro_torch.kernels import ops
from repro_torch.kernels.chunked_attention import (_fwd_plain,
                                                   _pick_chunk,
                                                   chunked_attention)
from repro_torch.kernels.flash_attention import (EMPTY_LSE,
                                                 flash_attention_plain)
from repro_torch.kernels.linear_scan import linear_scan_plain
from repro_torch.models.common import (causal_cross_entropy,
                                       causal_cross_entropy_ref)
from repro_torch.models.lm import LM
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

from test_torch_dense import _redraw_zeros

TOL = 1e-5
# The train steps hold their new parameters against the JAX optimizer
# applied to the port's own gradients, which are held against JAX's
# within TOL.  Against JAX's whole step they would be ill-conditioned:
# AdamW moves each element by about lr * g / (|g| + 1e-8), and elements
# with |g| near 1e-7 (mamba2's dt columns of w_in) carry float32
# summation-order differences of ~1e-7 in g, i.e. up to half of lr.
LR = 1e-2
FAMILIES = ("recurrentgemma-2b", "qwen2-0.5b", "mamba2-780m",
            "moonshot-v1-16b-a3b", "whisper-medium", "internvl2-2b")


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x, dtype=np.float32))
    return t.requires_grad_(grad)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the fused cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_and_its_gradient_match_jax(jax, with_mask):
    from repro.models.common import causal_cross_entropy as jce
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32) if with_mask \
        else None
    jm = None if mask is None else jax.numpy.asarray(mask)
    want, jgrad = jax.value_and_grad(lambda lg: jce(lg, labels, jm))(
        jax.numpy.asarray(logits))
    lt = _t(logits, grad=True)
    got = causal_cross_entropy(lt, torch.from_numpy(labels),
                               None if mask is None else _t(mask))
    (grad,) = torch.autograd.grad(got, lt)
    _close(got, want, "loss", 1e-6)
    _close(grad, jgrad, "dlogits")
    ref = causal_cross_entropy_ref(lt, torch.from_numpy(labels),
                                   None if mask is None else _t(mask))
    _close(got, ref.detach(), "against the reference", 1e-6)


def test_cross_entropy_streams_rows_in_chunks(monkeypatch):
    """Forced to one row a step, the loss and dlogits stay the same, and
    bf16 logits give bf16 dlogits."""
    from repro_torch.models import common
    rng = np.random.default_rng(2)
    logits = _t(rng.standard_normal((2, 5, 33)), grad=True)
    labels = torch.from_numpy(rng.integers(0, 33, (2, 5)))
    whole = causal_cross_entropy(logits, labels)
    (g_whole,) = torch.autograd.grad(whole, logits)
    monkeypatch.setattr(common, "CE_CHUNK_ELEMS", 1)
    rows = causal_cross_entropy(logits, labels)
    (g_rows,) = torch.autograd.grad(rows, logits)
    assert float(rows.detach()) == float(whole.detach())
    assert torch.equal(g_rows, g_whole)
    lb = logits.detach().bfloat16().requires_grad_()
    (gb,) = torch.autograd.grad(causal_cross_entropy(lb, labels), lb)
    assert gb.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# attention: forward, LSE and VJP
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, T, S, D, causal, window)
ATTN_CASES = [(2, 4, 4, 24, 24, 16, True, None),       # group 1
              (1, 4, 2, 20, 20, 8, False, None),       # group 2, no mask
              (2, 6, 2, 16, 40, 8, True, None),        # group 3, T < S
              (1, 8, 2, 33, 33, 16, True, 7),          # group 4, window
              (1, 4, 1, 12, 30, 8, False, 9),          # window, T < S
              (1, 4, 2, 48, 48, 8, True, 16)]          # window = chunk


def _qkv(seed, b, hq, hkv, t, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d),
                          (b, hq, t, d)))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_chunked_attention_and_its_vjp_match_jax(jax, case):
    """Forward and (dq, dk, dv) of the port's Function (the plain chunked
    forward on the CPU, the JAX backward's arithmetic) against the JAX
    ``chunked_attention``'s custom VJP, at a key chunk of 8 so several
    chunks (and ones no row sees) take part."""
    from repro.kernels.chunked_attention import chunked_attention as jca
    b, hq, hkv, t, s, d, causal, window = case
    q, k, v, do = _qkv(ATTN_CASES.index(case), b, hq, hkv, t, s, d)
    jnp = jax.numpy
    want, vjp = jax.vjp(functools.partial(jca, causal=causal, window=window,
                                          chunk=8),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    got = chunked_attention(tq, tk, tv, causal=causal, window=window,
                            chunk=8)
    _close(got, want, "out")
    grads = torch.autograd.grad(got, (tq, tk, tv), _t(do))
    for name, g, w in zip("qkv", grads, jgrads):
        _close(g, w, "d" + name)
    # ops.attention routes a call that needs a gradient through it
    again = ops.attention(tq, tk, tv, causal=causal, window=window)
    assert again.grad_fn is not None and "_Attention" in \
        type(again.grad_fn).__name__


@pytest.mark.parametrize("case", ATTN_CASES[:4])
def test_plain_lse_matches_jax_fwd(jax, case):
    """The row LSE of the plain chunked forward and of
    ``flash_attention_plain`` against the JAX ``_fwd``'s."""
    from repro.kernels.chunked_attention import _fwd as jfwd
    b, hq, hkv, t, s, d, causal, window = case
    q, k, v, _ = _qkv(7, b, hq, hkv, t, s, d)
    kc = _pick_chunk(s, 8)
    jout, jlse = jfwd(causal, window, 1.0 / d ** 0.5, kc, None,
                      *map(jax.numpy.asarray, (q, k, v)))
    out, lse = _fwd_plain(_t(q), _t(k), _t(v), causal, window, kc)
    _close(out, jout, "out")
    _close(lse, jlse, "chunked lse")
    pout, plse = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                       window=window, return_lse=True)
    _close(plse, jlse, "plain lse")
    _close(pout, jout, "plain out")


def test_a_row_with_no_key_gets_empty_lse_and_zero_gradients():
    """T > S, causal: the first rows see no key.  Their output is 0, their
    LSE :data:`EMPTY_LSE` in both plain forwards, and the backward gives
    finite gradients with nothing from those rows."""
    q, k, v, do = _qkv(3, 1, 2, 1, 10, 4, 8)
    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    _, lse = _fwd_plain(_t(q), _t(k), _t(v), True, None, 2)
    _, plse = flash_attention_plain(_t(q), _t(k), _t(v), return_lse=True)
    assert bool((lse[..., :6] == EMPTY_LSE).all())
    assert bool((plse[..., :6] == EMPTY_LSE).all())
    out = chunked_attention(tq, tk, tv, chunk=2)
    assert not out[..., :6, :].any()
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert not dq[..., :6, :].any()
    do2 = _t(do).clone()
    do2[..., :6, :] = 0
    dk2 = torch.autograd.grad(chunked_attention(tq, tk, tv, chunk=2), tk,
                              do2)[0]
    assert torch.equal(dk, dk2)


def test_no_grad_asks_for_no_lse(monkeypatch):
    """Under ``no_grad`` (the serve path) ``ops.attention`` calls the
    flash wrapper once, without ``return_lse``, and records no graph."""
    from repro_torch.kernels import chunked_attention as ca
    calls = []
    real = ca.flash_attention

    def spy(*a, **kw):
        calls.append(kw.get("return_lse", False))
        return real(*a, **kw)
    monkeypatch.setattr(ca, "flash_attention", spy)
    q, k, v, _ = _qkv(4, 1, 4, 2, 8, 8, 8)
    tq = _t(q, grad=True)
    with torch.no_grad():
        out = ops.attention(tq, _t(k), _t(v))
    assert calls == [False] and out.grad_fn is None


# ---------------------------------------------------------------------------
# the linear scan's gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_gradients_match_jax(jax, with_h0):
    from repro.kernels.ref import linear_scan_ref
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 11, 6)).astype(np.float32)
    a = rng.uniform(0.3, 1.0, (3, 11, 6)).astype(np.float32)
    h0 = rng.standard_normal((3, 6)).astype(np.float32) if with_h0 else None
    whs = rng.standard_normal((3, 11, 6)).astype(np.float32)
    wlast = rng.standard_normal((3, 6)).astype(np.float32)
    jnp = jax.numpy

    def jloss(x, a, h0):
        hs, last = linear_scan_ref(x, a, h0)
        return jnp.sum(hs * whs) + jnp.sum(last * wlast)
    args = [jnp.asarray(x), jnp.asarray(a)] + \
        ([jnp.asarray(h0)] if with_h0 else [None])
    argnums = (0, 1, 2) if with_h0 else (0, 1)
    jg = jax.grad(jloss, argnums=argnums)(*args)
    tx, ta = _t(x, grad=True), _t(a, grad=True)
    th0 = _t(h0, grad=True) if with_h0 else None
    hs, last = ops.linear_scan(tx, ta, th0)
    loss = (hs * _t(whs)).sum() + (last * _t(wlast)).sum()
    inputs = (tx, ta, th0) if with_h0 else (tx, ta)
    tg = torch.autograd.grad(loss, inputs)
    for name, g, w in zip(("dx", "da", "dh0"), tg, jg):
        _close(g, w, name)
    # and bit for bit against autograd through the plain loop
    phs, plast = linear_scan_plain(tx, ta, th0)
    pg = torch.autograd.grad((phs * _t(whs)).sum() +
                             (plast * _t(wlast)).sum(), inputs)
    for g, w in zip(tg, pg):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# optimizers over JAX leaves
# ---------------------------------------------------------------------------

def _jax_tree(jax, name, seed, **over):
    from repro.configs import get_arch, reduced
    from repro.models.lm import LM as JLM
    cfg = reduced(get_arch(name), **over)
    tcfg = t_reduced(t_get_arch(name), **over)
    tree = _redraw_zeros(jax.tree.map(
        np.asarray, JLM(cfg).init(jax.random.PRNGKey(seed))), seed)
    return cfg, tcfg, tree


def _leaves(tcfg, tree):
    """A JAX tree (params or gradients) as the port's leaves."""
    return jax_leaves(tcfg, lm_params_from_jax(tcfg, tree))


def _assert_leaves_close(got: dict, jtree, what):
    want = dict(_flatten(jtree))
    assert set(got) == set(want), what
    for k, leaf in got.items():
        _close(topt.whole(leaf), want[k], f"{what} {k}")


@pytest.mark.parametrize("name,kind", [
    ("qwen2-0.5b", "adamw"), ("mamba2-780m", "adamw"),
    ("whisper-medium", "adamw"), ("recurrentgemma-2b", "adamw"),
    ("llama3-405b", "adafactor"), ("qwen2-0.5b", "adafactor")])
def test_optimizers_match_jax_over_three_steps(jax, name, kind):
    """Three steps from one state, then one with zero gradients at a large
    learning rate: AdamW's decay on stacked biases (qwen2's ``bq``,
    mamba2's ``dt_bias``), Adafactor's factoring and ``rms_u`` over a
    stacked leaf.  llama3-405b's reduced config chooses Adafactor."""
    from repro.train import optimizer as jopt
    from repro_torch.configs import get_arch
    cfg, tcfg, tree = _jax_tree(jax, name, 11)
    if name == "llama3-405b":
        assert cfg.optimizer == tcfg.optimizer == "adafactor"
        assert get_arch(name).optimizer == "adafactor"
    jnp = jax.numpy
    make = {"adamw": (jopt.adamw, topt.adamw),
            "adafactor": (jopt.adafactor, topt.adafactor)}[kind]
    jo = make[0](jopt.cosine_schedule(0.05, 2, 10))
    to = make[1](topt.cosine_schedule(0.05, 2, 10))
    jbig, tbig = make[0](5.0), make[1](5.0)
    j_update, jbig_update = jax.jit(jo.update), jax.jit(jbig.update)
    jp = jax.tree.map(jnp.asarray, tree)
    model = LM(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(tcfg, tree))
    params = tts.param_leaves(model)
    js, ts = jo.init(jp), to.init(params)
    rng = np.random.default_rng(12)
    for step in range(4):
        if step < 3:
            g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
                np.float32), tree)
            jp, js = j_update(jax.tree.map(jnp.asarray, g), js, jp,
                              jnp.int32(step))
            params, ts = to.update(_leaves(tcfg, g), ts, params, step)
        else:                                   # zero grads, large lr
            g = jax.tree.map(np.zeros_like, tree)
            jp, _ = jbig_update(jax.tree.map(jnp.asarray, g),
                                jbig.init(jp), jp, jnp.int32(0))
            params, _ = tbig.update(_leaves(tcfg, g), tbig.init(params),
                                    params, 0)
        _assert_leaves_close(params, jp, f"step {step} params")
    key = "f" if kind == "adafactor" else "m"
    got = ts[key]
    want = dict(_flatten(js[key]))
    flat = {f"{k}.{s}": v for k, st in got.items() for s, v in st.items()} \
        if kind == "adafactor" else got
    assert set(flat) == set(want)
    for k in flat:
        _close(flat[k], want[k], f"state {k}")


def test_a_stacked_bias_is_decayed_as_jax_decays_it(jax):
    """qwen2's per-layer ``bq`` is 1-D, its JAX leaf (L, n) 2-D: AdamW
    decays it, so a zero-gradient step moves it (by lr * wd * p)."""
    _, tcfg, tree = _jax_tree(jax, "qwen2-0.5b", 3)
    model = LM(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(tcfg, tree))
    params = tts.param_leaves(model)
    assert isinstance(params["layers.attn.bq"], list)
    before = topt.whole(params["layers.attn.bq"]).clone()
    ln = topt.whole(params["layers.attn.ln"]).clone()
    opt = topt.adamw(1.0)
    zeros = {k: [torch.zeros_like(t) for t in v] if isinstance(v, list)
             else torch.zeros_like(v) for k, v in params.items()}
    opt.update(zeros, opt.init(params), params, 0)
    _close(topt.whole(params["layers.attn.bq"]), before * 0.9, "bq")
    assert torch.equal(topt.whole(params["layers.attn.ln"]), ln)


# ---------------------------------------------------------------------------
# one train step of every family
# ---------------------------------------------------------------------------

def _batch(cfg, seed, b=2, t=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, t)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = 0
    mask = np.ones((b, t), np.float32)
    mask[:, -1] = 0
    out = {"tokens": toks, "labels": labels, "mask": mask}
    if cfg.frontend != "none":
        fd = cfg.frontend_dim or cfg.d_model
        out["frontend"] = rng.standard_normal(
            (b, cfg.frontend_tokens, fd)).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=FAMILIES)
def F(request, jax):
    """The reduced JAX LM of a family, its params and one batch; the JAX
    loss, aux and gradients, and the JAX optimizer of the config."""
    from repro.models.blocks import Ctx
    from repro.models.lm import LM as JLM
    from repro.train import make_optimizer as jmake
    from repro.train.train_step import loss_fn as jloss
    name = request.param
    cfg, tcfg, tree = _jax_tree(jax, name, FAMILIES.index(name))
    jm = JLM(cfg)
    ctx = Ctx(cfg=cfg)
    batch = _batch(cfg, 21)
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(jax.numpy.asarray, tree)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(jm, p, jb, ctx=ctx), has_aux=True))(params)
    return dict(name=name, cfg=cfg, tcfg=tcfg, tree=tree, batch=batch,
                params=params, loss=float(loss), aux=float(metrics["aux"]),
                grads=grads, opt=jmake(cfg, base_lr=LR, warmup=1, total=10),
                jax=jax)


def _port(F, **over):
    tcfg = dataclasses.replace(F["tcfg"], **over)
    model = LM(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(tcfg, F["tree"]))
    return model


def _as_jax_tree(jax, like, leaves: dict):
    """The port's leaves (gradients) as a JAX tree shaped like ``like``."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(like)
    paths = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in flat]
    return jax.tree_util.tree_unflatten(treedef, [
        jax.numpy.asarray(_np(topt.whole(leaves[p])).astype(np.float32))
        for p in paths])


class _Capture:
    """A ``compress_fn`` that keeps the gradients it is handed."""

    def __call__(self, grads):
        self.grads = grads
        return grads


def test_one_train_step_matches_jax(F):
    """Loss, aux and every gradient (each JAX leaf, stacked ones whole)
    against JAX's; then the port's train step: its loss, its gradients
    (as the optimizer sees them) and its new parameters and AdamW
    moments against the JAX optimizer's update from those gradients."""
    jax = F["jax"]
    model = _port(F)
    batch = {k: torch.from_numpy(v) for k, v in F["batch"].items()}
    loss, metrics = tts.loss_fn(model, batch)
    params = tts.param_leaves(model)
    grads = tts._unflat(params, torch.autograd.grad(loss, tts._flat(params),
                                                    allow_unused=True))
    _close(loss, F["loss"], "loss")
    _close(metrics["aux"], F["aux"], "aux", 1e-6)
    if F["cfg"].n_experts:
        assert F["aux"] > 0
    want = dict(_flatten(F["grads"]))
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert all(x is not None for x in (g if isinstance(g, list)
                                           else [g])), k
        _close(topt.whole(g), want[k], f"grad {k}")
    from repro_torch.train import make_optimizer
    opt = make_optimizer(model.cfg, base_lr=LR, warmup=1, total=10)
    seen = _Capture()
    step = tts.make_train_step(model, opt, compress_fn=seen)
    state, m = step(tts.init_train_state(model, opt), batch)
    _close(m["loss"], F["loss"], "step loss")
    assert m["step"] == 0 and state.step == 1
    for k, g in seen.grads.items():
        _close(topt.whole(g), topt.whole(grads[k]), f"step grad {k}", 0)
    jp, jo = F["params"], F["opt"]
    new_p, new_o = jax.jit(jo.update)(_as_jax_tree(jax, jp, seen.grads),
                                      jo.init(jp), jp, jax.numpy.int32(0))
    _assert_leaves_close(state.params, new_p, "new params")
    _assert_leaves_close(state.opt["v"], new_o["v"], "v")


@pytest.mark.parametrize("name", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_the_step_trains_with_remat_off_as_with_it_on(jax, name):
    """``cfg.remat`` only trades memory for recomputation: the gradients
    are the same with it off."""
    _, tcfg, tree = _jax_tree(jax, name, 13)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 14).items()}
    grads = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model = LM(cfg, device="cpu")
        model.load_state_dict(lm_params_from_jax(cfg, tree))
        loss, _ = tts.loss_fn(model, batch)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        _close(a, b, "remat", 1e-6)


def test_grad_accum_two_equals_one(jax):
    """Two microbatches of 2 rows give the step one batch of 4 gives: the
    loss, the gradients the optimizer is handed and their norm (equal
    mask counts per microbatch)."""
    _, tcfg, tree = _jax_tree(jax, "qwen2-0.5b", 8)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(tcfg, 9, b=4).items()}
    out = []
    for accum in (1, 2):
        model = LM(tcfg, device="cpu")
        model.load_state_dict(lm_params_from_jax(tcfg, tree))
        opt = topt.make_optimizer(tcfg, base_lr=LR, warmup=1)
        seen = _Capture()
        step = tts.make_train_step(model, opt, grad_accum=accum,
                                   compress_fn=seen)
        _, m = step(tts.init_train_state(model, opt), batch)
        out.append((seen.grads, m))
    (g1, m1), (g2, m2) = out
    _close(m2["loss"], m1["loss"], "loss", 1e-6)
    _close(m2["grad_norm"], m1["grad_norm"], "grad_norm")
    assert set(g1) == set(g2)
    for k in g1:
        _close(topt.whole(g2[k]), topt.whole(g1[k]), k)
        assert all(x.dtype == torch.float32 for x in
                   (g2[k] if isinstance(g2[k], list) else [g2[k]]))


def test_train_state_from_jax_takes_one_step_as_jax_does(jax):
    """A JAX state after one step, converted (params, AdamW moments or
    Adafactor factors, step), then one more step on both sides (mamba2,
    AdamW; llama3-405b's reduced config, Adafactor): loss and grad norm
    against JAX's step, new parameters against the JAX optimizer's
    update from the converted state and the port's gradients."""
    from repro.models.blocks import Ctx
    from repro.models.lm import LM as JLM
    from repro.train import make_optimizer as jmake
    from repro.train.train_step import TrainState as JState
    from repro.train.train_step import make_train_step as jstep
    from repro_torch.train import make_optimizer
    for name in ("mamba2-780m", "llama3-405b"):
        cfg, tcfg, tree = _jax_tree(jax, name, 5)
        jm = JLM(cfg)
        jo = jmake(cfg, base_lr=LR, warmup=1, total=10)
        jfn = jax.jit(jstep(jm, jo, ctx=Ctx(cfg=cfg)))
        params = jax.tree.map(jax.numpy.asarray, tree)
        state = JState(params, jo.init(params), jax.numpy.int32(0))
        b0, b1 = (_batch(cfg, s) for s in (1, 2))
        state, _ = jfn(state, {k: jax.numpy.asarray(v)
                               for k, v in b0.items()})
        model = LM(tcfg, device="cpu")
        tstate = tts.load_train_state(model,
                                      train_state_from_jax(tcfg, state))
        assert tstate.step == 1
        after, jm_ = jfn(state, {k: jax.numpy.asarray(v)
                                 for k, v in b1.items()})
        to = make_optimizer(tcfg, base_lr=LR, warmup=1, total=10)
        seen = _Capture()
        tstate, tm = tts.make_train_step(model, to, compress_fn=seen)(
            tstate, {k: torch.from_numpy(v) for k, v in b1.items()})
        _close(tm["loss"], float(jm_["loss"]), f"{name} loss")
        _close(tm["grad_norm"], float(jm_["grad_norm"]), f"{name} gnorm")
        new_p, _ = jax.jit(jo.update)(
            _as_jax_tree(jax, state.params, seen.grads), state.opt,
            state.params, state.step)
        _assert_leaves_close(tstate.params, new_p, name)
        assert tm["step"] == 1 and int(after.step) == tstate.step == 2


# ---------------------------------------------------------------------------
# data, compression, checkpoints, the launcher
# ---------------------------------------------------------------------------

def test_batch_at_equals_jax(jax):
    from repro.data.lm_pipeline import LMPipeline as JPipe
    from repro.data.lm_pipeline import PipelineSpec as JSpec
    from repro_torch.data.lm_pipeline import LMPipeline, PipelineSpec
    spec = dict(vocab_size=997, seq_len=33, global_batch=12, seed=4)
    jp, tp = JPipe(JSpec(**spec)), LMPipeline(PipelineSpec(**spec))
    for step in (0, 1, 17):
        want, got = jp.batch_at(step), tp.batch_at(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(tp.host_slice(3, 1, 3)["tokens"],
                                  jp.host_slice(3, 1, 3)["tokens"])
    np.testing.assert_array_equal(JPipe.reassign(4, 12, {1}),
                                  LMPipeline.reassign(4, 12, {1}))


def test_factorized_store_equals_jax(jax):
    from repro.data.lm_pipeline import LMPipeline as JPipe
    from repro.data.lm_pipeline import PipelineSpec as JSpec
    from repro_torch.data.lm_pipeline import LMPipeline, PipelineSpec
    spec = dict(vocab_size=300, seq_len=16, global_batch=8, seed=2,
                n_templates=5)
    js = JPipe(JSpec(**spec)).factorized_corpus(200)
    ts = LMPipeline(PipelineSpec(**spec)).factorized_corpus(200)
    np.testing.assert_array_equal(ts.molecules, js.molecules)
    np.testing.assert_array_equal(ts.instance_of, js.instance_of)
    assert ts.bytes_stored == js.bytes_stored
    idx = np.array([[3, 7, 3], [150, 9, 0]])
    np.testing.assert_array_equal(ts.batch(idx), js.batch(idx))
    np.testing.assert_array_equal(ts.batch(idx, device="cpu").numpy(),
                                  js.batch(idx))


def test_int8_codes_and_scales_equal_jax(jax):
    from repro.dist import compression as jc
    from repro_torch.dist import compression as tc
    rng = np.random.default_rng(6)
    for shape in ((), (5,), (4, 9), (2, 3, 7)):
        g = (rng.standard_normal(shape) * 3).astype(np.float32)
        g.reshape(-1)[::4] = 0.5 * np.abs(g.reshape(-1)[::4]).round()
        jq, js = jc.quantize_int8(jax.numpy.asarray(g))
        tq, ts = tc.quantize_int8(torch.from_numpy(np.array(g)))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tc.make_pod_compress_fn(n_pods=1) is None
    assert tc.make_pod_compress_fn() is None


def test_compressed_optimizer_matches_jax(jax):
    """Error feedback over two steps through ``compressed(adamw)``."""
    from repro.dist.compression import compressed as jcomp
    from repro.train import optimizer as jopt
    from repro_torch.dist.compression import compressed
    _, tcfg, tree = _jax_tree(jax, "qwen2-0.5b", 4)
    jo, to = jcomp(jopt.adamw(0.01)), compressed(topt.adamw(0.01))
    j_update = jax.jit(jo.update)
    jp = jax.tree.map(jax.numpy.asarray, tree)
    model = LM(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(tcfg, tree))
    params = tts.param_leaves(model)
    js, ts = jo.init(jp), to.init(params)
    rng = np.random.default_rng(7)
    for step in range(2):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32) * 1e-3, tree)
        jp, js = j_update(jax.tree.map(jax.numpy.asarray, g), js, jp,
                          jax.numpy.int32(step))
        params, ts = to.update(_leaves(tcfg, g), ts, params, step)
    _assert_leaves_close(params, jp, "params")
    _assert_leaves_close(ts["ef"], js["ef"], "ef")


def test_checkpoint_save_restore_and_retention():
    from repro_torch.ckpt import Checkpointer, latest_step
    cfg = t_reduced(t_get_arch("qwen2-0.5b"), dtype="bfloat16",
                    param_dtype="bfloat16")
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = topt.make_optimizer(cfg)
    state = tts.init_train_state(model, opt)
    state = state._replace(step=7)
    with tempfile.TemporaryDirectory() as root:
        ck = Checkpointer(root, keep=2)
        for s in (1, 2, 3):
            ck.save(state, s)
        ck.wait()
        assert latest_step(root) == 3
        assert sorted(__import__("os").listdir(root)) == ["step_000002",
                                                          "step_000003"]
        want = {k: v.detach().clone() for k, v in model.state_dict().items()}
        other = LM(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(1))
        like = tts.init_train_state(other, opt)
        got, step = ck.restore(like)
        assert step == 3 and got.step == 7
        for k, v in other.state_dict().items():
            assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_launch_train_losses_equal_jax(jax, arch, monkeypatch, capsys):
    """``launch.train.main`` with the JAX launcher's argv, its model built
    with the JAX launcher's initial weights: every loss within 1e-5."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    argv = ["--arch", arch, "--reduced", "--steps", "4", "--batch", "2",
            "--seq", "32", "--log-every", "1"]
    want = jtrain.main(argv)
    from repro.configs import get_arch, reduced
    from repro.models.lm import LM as JLM
    tree = jax.tree.map(np.asarray, JLM(reduced(get_arch(arch))).init(
        jax.random.PRNGKey(0)))
    tcfg = t_reduced(t_get_arch(arch))

    def jax_weights(cfg, device, generator):
        assert cfg == tcfg
        model = LM(cfg, device=device)
        model.load_state_dict(lm_params_from_jax(cfg, tree))
        return model
    monkeypatch.setattr(ttrain, "LM", jax_weights)
    got = ttrain.main(argv + ["--device", "cpu"])
    assert set(got) == set(want)
    _close(np.array(got["losses"]), np.array(want["losses"]), "losses")
    assert got["steps_done"] == want["steps_done"] == 4


def test_launch_train_resume_is_bit_identical(capsys):
    """A run preempted after step 3, resumed from its checkpoint, gives
    the losses of an uninterrupted run exactly."""
    from repro_torch.launch import train as ttrain
    base = ["--reduced", "--device", "cpu", "--steps", "6", "--batch",
            "2", "--seq", "16", "--ckpt-every", "3"]
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        full = ttrain.main(base + ["--ckpt-dir", a])
        first = ttrain.main(base + ["--ckpt-dir", b, "--preempt-at", "3"])
        rest = ttrain.main(base + ["--ckpt-dir", b])
    assert first["preempted"] and first["steps_done"] == 3
    assert first["losses"] + rest["losses"] == full["losses"]
    assert "resumed from step 3" in capsys.readouterr().out
    out = ttrain.main(base + ["--compress-grads", "--pods", "2",
                              "--steps", "2"])
    assert out["grad_compression"] == "pod-boundary"


# ---------------------------------------------------------------------------
# on the card (skipped where no CUDA device is present)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_lse_matches_plain(cuda, dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    for b, hq, hkv, t, s, d, causal, window in [
            (2, 4, 2, 77, 77, 64, True, None), (1, 4, 1, 130, 70, 128,
                                                True, None),
            (1, 4, 2, 100, 300, 64, False, 40)]:
        q, k, v, _ = (torch.from_numpy(x).to(cuda, dtype)
                      for x in _qkv(0, b, hq, hkv, t, s, d))
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        _, want = flash_attention_plain(q, k, v, causal=causal,
                                        window=window, return_lse=True)
        torch.cuda.synchronize()
        assert lse.dtype == torch.float32
        assert float((lse - want).abs().max()) <= 1e-4
        assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                                window=window))


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda):
    """One step of reduced float32 qwen2 and recurrentgemma at head_dim 64
    through the kernels on the card (flash with its LSE, the scan and its
    reverse) against the same step on the CPU: loss and every gradient
    within 1e-5, and the card's new parameters against the CPU optimizer
    fed the card's gradients (as the JAX comparisons above)."""
    for name in ("qwen2-0.5b", "recurrentgemma-2b"):
        cfg = t_reduced(t_get_arch(name), head_dim=64)
        batch = _batch(cfg, 3, b=2, t=64)
        init = LM(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0)).state_dict()
        out = []
        for dev in (cuda, torch.device("cpu")):
            model = LM(cfg, device=dev)
            model.load_state_dict(init)
            opt = topt.make_optimizer(cfg, base_lr=LR, warmup=1)
            seen = _Capture()
            state, m = tts.make_train_step(model, opt, compress_fn=seen)(
                tts.init_train_state(model, opt),
                {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            out.append((float(m["loss"]), seen.grads, state.params))
        (l1, g1, p1), (l2, g2, _) = out
        assert abs(l1 - l2) <= 1e-5, name
        for k in g2:
            _close(topt.whole(g1[k]).cpu(), topt.whole(g2[k]), f"{name} {k}")
        model = LM(cfg, device="cpu")
        model.load_state_dict(init)
        opt = topt.make_optimizer(cfg, base_lr=LR, warmup=1)
        ref = tts.init_train_state(model, opt)
        opt.update({k: [t.cpu() for t in g] if isinstance(g, list)
                    else g.cpu() for k, g in g1.items()}, ref.opt,
                   ref.params, 0)
        for k in ref.params:
            _close(topt.whole(p1[k]).cpu(), topt.whole(ref.params[k]),
                   f"{name} new {k}")


def _emulated_kernel(q, k, v, causal, window, chunk, sign):
    """The bf16 tensor-core forward's rounding (bf16 P before PV, float32
    l, bf16 output) and an LSE off by the whole tolerance in one
    direction: what the backward on the card is fed at worst."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_attention import lse_tolerance
    group = q.shape[1] // k.shape[1]
    kx, vx = (x.repeat_interleave(group, dim=1).float() for x in (k, v))
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), kx) / q.shape[3] ** 0.5
    mask = ref.attention_mask(q.shape[2], k.shape[2], causal, window)
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m).nan_to_num(0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhts,bhsd->bhtd", p.bfloat16().float(), vx)
    out = torch.where(l > 0, o / l, 0.0).bfloat16()
    lse = (m + torch.log(l))[..., 0] + sign * lse_tolerance(k.shape[2])
    return out, lse


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_bf16_grad_limits_hold_the_kernel_rounding_and_see_a_lost_chunk(
        monkeypatch, sign):
    """On the CPU: the backward fed the emulated bf16 kernel's output and
    an LSE off by its tolerance stays within every row's limit of
    ``bf16_grad_row_limits``; the same backward with one key chunk left
    out does not."""
    from repro_torch.kernels import chunked_attention as ca
    b, hq, hkv, t, s, d = 1, 4, 2, 96, 96, 32
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _qkv(8, b, hq, hkv, t, s, d))
    lq, lk, lv = (x.float().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(
        flash_attention_plain(*(x.bfloat16() for x in (lq, lk, lv))),
        (lq, lk, lv), do)
    want = tuple(w.bfloat16() for w in want)
    out, lse = _emulated_kernel(q, k, v, True, None, 32, sign)
    limits = ca.bf16_grad_row_limits(q, k, v, do, want, out, lse)
    got = ca.attention_bwd(q, k, v, out, lse, do, chunk=32)

    def over(grads):
        return [bool(((g.float() - w.float()).abs().amax(-1, keepdim=True)
                      > lim).any())
                for g, w, lim in zip(grads, want, limits)]
    assert over(got) == [False, False, False]
    real = ca._rows
    monkeypatch.setattr(ca, "_rows", lambda t_, s_, k0, k1, c, w: (
        (0, 0) if k0 == 32 else real(t_, s_, k0, k1, c, w)))
    lost = ca.attention_bwd(q, k, v, out, lse, do, chunk=32)
    assert over(lost) == [True, True, True]
