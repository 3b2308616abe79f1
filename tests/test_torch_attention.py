"""repro_torch attention against the JAX reference.

The plain version of the port's ``flash_attention`` against the Pallas
kernel in interpret mode and against ``repro.kernels.ref.mha_ref``;
the port's ``decode_attention`` against its JAX twin; the hand CUDA
kernel against its plain version where a card is present.

Tolerances: float32 on the CPU, 1e-5 absolute -- both sides compute in
float32 and differ only in summation order over at most 64 keys of
unit-scale values.  On the card, float32 1e-5 absolute (the kernel sums
in its own order over up to 2304 keys) and bfloat16 two bf16 steps at
the largest |output| of the case (both sides round float32 results that
differ in summation order only to bf16, so they part by at most one
step, ``2 ** (floor(log2 m) - 7)`` at magnitude m).

The JAX package is imported inside the ``J`` fixture, so on a machine
with a card and no jax this file still imports and the CUDA cases run.
"""
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels.chunked_attention import NEG_INF, decode_attention

TOL_F32 = 1e-5


def _cuda_tol(want: torch.Tensor) -> float:
    if want.dtype == torch.float32:
        return TOL_F32
    m = want.float().abs().max().item()
    return 2 * 2.0 ** (math.floor(math.log2(m)) - 7)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.chunked_attention import decode_attention as jdecode
    from repro.kernels.flash_attention import flash_attention as jflash
    return types.SimpleNamespace(jnp=jnp, ref=jref, flash=jflash,
                                 decode=jdecode)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def _qkv(seed, b, hq, hkv, t, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _port(q, k, v, **kw):
    return ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), **kw).numpy()


# (B, Hq, Hkv, T, S, D, causal, window): GQA groups 1, 2, 4; ragged T and
# S; T < S (a q offset); windows
CASES = [(2, 4, 2, 16, 16, 32, True, None),
         (1, 4, 1, 13, 37, 32, True, 8),
         (2, 2, 2, 20, 20, 16, False, None),
         (1, 6, 3, 7, 50, 64, True, None),
         (2, 4, 4, 33, 33, 32, True, 5),
         (1, 4, 2, 9, 40, 32, False, 12)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_mha_ref(J, case):
    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = _qkv(sum(case[:6]), b, hq, hkv, t, s, d)
    got = _port(q, k, v, causal=causal, window=window)
    want = np.asarray(J.ref.mha_ref(J.jnp.asarray(q), J.jnp.asarray(k),
                                    J.jnp.asarray(v), causal=causal,
                                    window=window))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("case", [c for c in CASES if c[6]], ids=str)
def test_plain_matches_pallas_interpret(J, case):
    """Small tiles, so the Pallas kernel walks several q and KV blocks."""
    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = _qkv(sum(case[:6]), b, hq, hkv, t, s, d)
    got = _port(q, k, v, causal=causal, window=window)
    want = np.asarray(J.flash(J.jnp.asarray(q), J.jnp.asarray(k),
                              J.jnp.asarray(v), causal=causal, window=window,
                              tq=8, tkv=16, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


def test_non_causal_ragged_s_matches_mha_ref_not_pallas_padding(J):
    """causal=False with S not a multiple of the KV tile: the Pallas
    kernel attends its zero-padded keys (ROADMAP §3), the port does not."""
    q, k, v = _qkv(7, 1, 2, 1, 8, 37, 32)
    jq, jk, jv = (J.jnp.asarray(x) for x in (q, k, v))
    got = _port(q, k, v, causal=False)
    want = np.asarray(J.ref.mha_ref(jq, jk, jv, causal=False))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)
    padded = np.asarray(J.flash(jq, jk, jv, causal=False, tkv=16,
                                interpret=True))
    assert np.abs(padded - want).max() > 1e-3


def test_fully_masked_rows_are_zero(J):
    """T > S, causal: the first T - S query rows see no key.  The port
    gives 0 there, as the Pallas kernel does; mha_ref gives NaN."""
    q, k, v = _qkv(3, 1, 2, 1, 10, 6, 32)
    jq, jk, jv = (J.jnp.asarray(x) for x in (q, k, v))
    got = _port(q, k, v, causal=True)
    pallas = np.asarray(J.flash(jq, jk, jv, causal=True, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL_F32)
    assert (got[:, :, :4] == 0).all()
    mha = np.asarray(J.ref.mha_ref(jq, jk, jv, causal=True))
    assert np.isnan(mha[:, :, :4]).all()
    np.testing.assert_allclose(got[:, :, 4:], mha[:, :, 4:], rtol=0,
                               atol=TOL_F32)


@pytest.mark.parametrize("s", [64, 100, 2000])
def test_decode_attention_matches_jax(J, s):
    """At the default chunk; S = 2000 takes two online-softmax steps."""
    rng = np.random.default_rng(s)
    b, hkv, g, d = 2, 2, 3, 32
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    bias = np.where(rng.random((b, s)) < 0.7, 0.0, NEG_INF).astype(np.float32)
    got = decode_attention(*(torch.from_numpy(x)
                             for x in (q, k, v, bias))).numpy()
    want = np.asarray(J.decode(*(J.jnp.asarray(x) for x in (q, k, v, bias))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = fa.launches
    q = torch.zeros((1, 2, 4, 32))
    out = ops.attention(q, q[:, :1], q[:, :1])
    assert out.shape == q.shape and fa.launches == before


def test_wrapper_rejects_bad_arguments():
    q = torch.zeros((1, 4, 8, 32))
    with pytest.raises(ValueError):
        ops.attention(q, torch.zeros((1, 3, 8, 32)), torch.zeros((1, 3, 8, 32)))
    with pytest.raises(ValueError):
        ops.attention(q, q[:, :2], q[:, :1])
    with pytest.raises(TypeError):
        ops.attention(q, q[:, :2].double(), q[:, :2].double())
    with pytest.raises(ValueError):
        ops.attention(q, q[:, :2], q[:, :2], window=0)


# ---------------------------------------------------------------------------
# the hand CUDA kernel (runs only where a card is present)
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, T, S, D, causal, window): ragged T and S, T < S, T > S
# (fully masked rows), GQA groups 1, 2 and 10, D 64 and 256
CUDA_CASES = [(2, 4, 4, 64, 64, 64, True, None),
              (1, 10, 1, 100, 300, 256, True, 128),
              (2, 4, 2, 77, 77, 64, False, None),
              (1, 4, 2, 37, 130, 64, False, 40),
              (1, 2, 1, 70, 20, 64, True, None),
              (2, 10, 1, 200, 200, 256, True, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", CUDA_CASES, ids=str)
def test_cuda_flash_attention_matches_plain(cuda, case, dtype):
    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)
               for x in _qkv(sum(case[:6]), b, hq, hkv, t, s, d))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _cuda_tol(want), err


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_unbuilt_head_dim(cuda):
    q = torch.zeros((1, 2, 8, 32), device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(2, 3), q.transpose(2, 3),
                           q.transpose(2, 3))
