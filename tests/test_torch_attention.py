"""repro_torch attention against the JAX reference.

The plain version of the port's ``flash_attention`` against the Pallas
kernel in interpret mode and against ``repro.kernels.ref.mha_ref``;
the port's ``decode_attention`` against its JAX twin; the wrapper's
routing of each type to its kernel; the two hand CUDA kernels against
their plain version where a card is present.

Tolerances: float32 on the CPU, 1e-5 absolute -- both sides compute in
float32 and differ only in summation order over at most 64 keys of
unit-scale values.  On the card, float32 (the CUDA-core kernel) 1e-5
absolute: it sums in its own order over up to 2304 keys.  bfloat16 (the
tensor-core kernel): ``flash_attention.bf16_row_limit``, a limit for each
query row.  The kernel rounds each softmax weight to bf16 before PV (l
sums them unrounded), a relative change of at most 2 ** -9 per weight,
which moves output j of a row by at most 2 ** -9 * sum_k p_k |v_kj|;
both sides then round to bf16, half a step each at the row's magnitude
(one step at magnitude m is ``2 ** (floor(log2 m) - 7)``).  So a row's
limit is two bf16 steps at its largest |output| plus 2 ** -9 times its
largest sum_k p_k |v_kj|.  A row that averages about 2000 unit-normal
values has outputs near 0.04 but sums near 0.8, so the second term
dominates there: about 2.7e-3 in all.  The limit must see a wrong kernel:
the plain version with one in-band 64-key tile left out of PV breaks it.

The JAX package is imported inside the ``J`` fixture, so on a machine
with a card and no jax this file still imports and the CUDA cases run.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels.chunked_attention import NEG_INF, decode_attention

TOL_F32 = 1e-5


def _limit(q, k, v, want, causal, window):
    """float32: TOL_F32; bf16: the limit of each query row."""
    if want.dtype == torch.float32:
        return TOL_F32
    return fa.bf16_row_limit(q, k, v, want, causal=causal, window=window)


def _within(got, want, limit) -> bool:
    return bool(((got.float() - want.float()).abs() <= limit).all())


def _without_tile(v, s):
    """v with the 64-key tile at the middle of its S keys zeroed: the
    plain version on it is a kernel that leaves that tile out of PV."""
    lo = s // 2 // 64 * 64
    out = v.clone()
    out[:, :, lo:lo + 64] = 0
    return out


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


@pytest.mark.parametrize("dtype, d, entry", [
    (torch.bfloat16, 256, "repro_flash_attention_sm90"),
    (torch.bfloat16, 64, "repro_flash_attention_sm90"),
    (torch.bfloat16, 128, "repro_flash_attention_sm90"),
    (torch.float32, 256, "repro_flash_attention"),
    (torch.float32, 128, "repro_flash_attention"),
    (torch.float32, 64, "repro_flash_attention")], ids=str)
def test_wrapper_routes_each_type_to_its_kernel(dtype, d, entry):
    """bf16 to the tensor-core kernel, float32 to the CUDA-core one."""
    assert fa.kernel_for(dtype, d) == entry


@pytest.mark.parametrize("dtype, d, error", [
    (torch.float16, 256, TypeError), (torch.float64, 64, TypeError),
    (torch.bfloat16, 96, ValueError), (torch.float32, 32, ValueError)],
    ids=str)
def test_wrapper_routes_no_other_type_or_head_dim(dtype, d, error):
    with pytest.raises(error):
        fa.kernel_for(dtype, d)


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


def _p_rounded(q, k, v, causal, window):
    """The tensor-core kernel's rounding in plain torch: float32 scores
    and weights, each weight rounded to bf16 before PV, l summed from the
    unrounded weights, the output rounded to bf16."""
    group = q.shape[1] // k.shape[1]
    kx, vx = (x.repeat_interleave(group, dim=1).float() for x in (k, v))
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), kx) / q.shape[3] ** 0.5
    mask = ref.attention_mask(q.shape[2], k.shape[2], causal, window)
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True)).nan_to_num(0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhts,bhsd->bhtd", p.bfloat16().float(), vx)
    return torch.where(l > 0, o / l, 0.0).bfloat16()


# (B, Hq, Hkv, T, S, D, causal, window): a band of 128, a q offset, a
# ragged S under no mask, long rows
LIMIT_CASES = [(1, 4, 1, 300, 300, 64, True, 128),
               (1, 2, 1, 256, 600, 64, True, None),
               (2, 4, 2, 130, 70, 64, False, None),
               (1, 2, 1, 200, 1200, 32, True, 1000)]


@pytest.mark.parametrize("case", LIMIT_CASES, ids=str)
def test_bf16_row_limit_holds_p_rounding_and_sees_a_lost_tile(case):
    """On the CPU: the kernel's rounding, emulated, stays within every
    row's limit; the plain version with one in-band tile left out of PV
    does not."""
    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(sum(case[:6]), b, hq, hkv, t, s, d))
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    limit = fa.bf16_row_limit(q, k, v, want, causal=causal, window=window)
    assert limit.shape == (b, hq, t, 1)
    assert _within(_p_rounded(q, k, v, causal, window), want, limit)
    wrong = fa.flash_attention_plain(q, k, _without_tile(v, s),
                                     causal=causal, window=window)
    assert not _within(wrong, want, limit)


def test_bf16_row_limit_is_zero_on_rows_with_no_key():
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(3, 1, 2, 1, 10, 6, 32))
    want = fa.flash_attention_plain(q, k, v)
    limit = fa.bf16_row_limit(q, k, v, want)
    assert (limit[:, :, :4] == 0).all() and (limit[:, :, 4:] > 0).all()


def _tile_schedule(q, k, v, causal, window, tq=64, tk=256):
    """The float32 CUDA-core kernel's schedule in plain torch: per 64-row
    query tile, the 256-key KV tiles from the band's first key, each taken
    as float32 scores, a running max and sum rescaled once per tile in the
    kernel's order (corr = exp(m - m_new), l = l * corr + sum p, acc =
    acc * corr + P V), and acc / l at the end (0 where l = 0)."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    out = torch.zeros_like(q)
    neg = -1e30
    for q0 in range(0, t, tq):
        rows = torch.arange(q0, min(q0 + tq, t))
        qpos = rows + s - t
        k_begin = max(0, int(qpos[0]) - window + 1) if window else 0
        k_end = min(s, int(qpos[-1]) + 1) if causal else s
        qt = q[:, :, rows]
        m = torch.full((b, hq, len(rows), 1), neg)
        l = torch.zeros((b, hq, len(rows), 1))
        acc = torch.zeros((b, hq, len(rows), d))
        for k0 in range(k_begin, k_end, tk):
            keys = torch.arange(k0, min(k0 + tk, s))
            kt = k[:, :, keys].repeat_interleave(hq // hkv, dim=1)
            vt = v[:, :, keys].repeat_interleave(hq // hkv, dim=1)
            ok = torch.ones((len(rows), len(keys)), dtype=torch.bool)
            if causal:
                ok &= keys[None, :] <= qpos[:, None]
            if window:
                ok &= keys[None, :] > qpos[:, None] - window
            sc = torch.where(ok, (qt @ kt.transpose(-1, -2)) / d ** 0.5, neg)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(sc - m_new), 0.0)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ vt
            m = m_new
        out[:, :, rows] = torch.where(l > 0, acc / l, 0.0)
    return out


# (B, Hq, Hkv, T, S, D, causal, window): T and S off the 64-row and
# 256-key tiles, several key tiles a row, T < S, a window under one V
# chunk (32 keys), fully masked rows, GQA groups 1, 2 and 10
SCHEDULE_CASES = [(1, 2, 1, 150, 700, 64, True, None),
                  (1, 4, 2, 70, 600, 64, True, 300),
                  (2, 2, 2, 65, 513, 32, False, None),
                  (1, 10, 1, 100, 300, 64, True, 17),
                  (1, 2, 1, 330, 60, 32, True, None),
                  (1, 2, 1, 96, 257, 256, False, 50)]


@pytest.mark.parametrize("case", SCHEDULE_CASES, ids=str)
def test_float32_tile_schedule_matches_plain(case):
    """The CUDA-core kernel's online softmax over 256-key tiles, in its
    rescale order, stays within 1e-5 of the plain version in float32: its
    rounding fits the tolerance before the card runs it."""
    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = (torch.from_numpy(x)
               for x in _qkv(sum(case[:6]), b, hq, hkv, t, s, d))
    got = _tile_schedule(q, k, v, causal, window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert _within(got, want, TOL_F32)
    if t > s and causal:
        assert (got[:, :, :t - s] == 0).all()


# ---------------------------------------------------------------------------
# the hand CUDA kernel (runs only where a card is present)
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, T, S, D, causal, window): ragged T and S, T < S, T > S
# (fully masked rows; at T = 300, S = 20 whole query tiles see no key),
# GQA groups 1, 2 and 10, D 64, 128 and 256
CUDA_CASES = [(2, 4, 4, 64, 64, 64, True, None),
              (2, 4, 4, 64, 64, 128, True, None),
              (2, 4, 2, 77, 77, 128, False, None),
              (1, 4, 2, 100, 300, 128, True, None),
              (1, 4, 4, 37, 130, 128, False, 40),
              (1, 2, 1, 70, 20, 128, True, None),
              (1, 10, 1, 100, 300, 256, True, 128),
              (2, 4, 2, 77, 77, 64, False, None),
              (1, 4, 2, 37, 130, 64, False, 40),
              (1, 2, 1, 70, 20, 64, True, None),
              (1, 2, 1, 300, 20, 256, True, None),
              (2, 10, 1, 200, 200, 256, True, None)]
# the serve path's own prefill shapes (recurrentgemma-2b, window 2048:
# the flat prefill and the batch-1 molecule prefill), and T and S that
# are multiples of neither the 128-row query tile nor the 64-key KV tile
PATH_CASES = [(8, 10, 1, 2304, 2304, 256, True, 2048),
              (1, 10, 1, 2048, 2048, 256, True, 2048),
              (2, 10, 1, 201, 333, 256, True, 100),
              (1, 4, 2, 130, 70, 64, False, None),
              # moonshot-v1-16b-a3b's flat prefill (D 128, group 1),
              # whisper's encoder (non-causal, S = 1500) and its
              # cross-attention at T = 1
              (8, 16, 16, 2304, 2304, 128, True, None),
              (2, 16, 16, 1500, 1500, 64, False, None),
              (8, 16, 16, 1, 1500, 64, False, None)]


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
    assert _within(got, want, _limit(q, k, v, want, causal, window))


# float32 at the CUDA-core kernel's tile edges (64 query rows, 256-key
# tiles, 32-key V chunks): T and S one off a tile either way, T < S, a
# window under one V chunk, fully masked rows (T > S), GQA groups 1, 2
# and 10, D 64, 128 and 256
F32_EDGE_CASES = [(1, 2, 2, 63, 255, 64, True, None),
                  (1, 2, 2, 65, 257, 128, True, None),
                  (2, 4, 2, 127, 511, 128, False, None),
                  (1, 2, 1, 65, 257, 64, True, None),
                  (2, 4, 2, 127, 511, 256, False, None),
                  (1, 10, 1, 129, 400, 256, True, 17),
                  (1, 10, 1, 64, 1000, 64, True, 31),
                  (1, 4, 2, 200, 130, 256, True, None),
                  (1, 2, 1, 300, 33, 64, False, 33),
                  (2, 10, 1, 513, 513, 256, True, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_EDGE_CASES, ids=str)
def test_cuda_flash_attention_float32_at_tile_edges(cuda, case):
    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in _qkv(sum(case[:6]), b, hq, hkv, t, s, d))
    before = fa.cuda_core_launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.cuda_core_launches == before + 1
    assert _within(got, want, TOL_F32)
    if t > s and causal:
        assert (got[:, :, :t - s] == 0).all()


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_unbuilt_head_dim(cuda):
    q = torch.zeros((1, 2, 8, 32), device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(2, 3), q.transpose(2, 3),
                           q.transpose(2, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("case", PATH_CASES, ids=str)
def test_cuda_flash_attention_bf16_at_path_shapes(cuda, case):
    """Within each row's limit, which a kernel that left one in-band
    64-key tile out of PV would break."""
    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in _qkv(sum(case[:6]), b, hq, hkv, t, s, d))
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    limit = _limit(q, k, v, want, causal, window)
    assert _within(got, want, limit)
    wrong = fa.flash_attention_plain(q, k, _without_tile(v, s),
                                     causal=causal, window=window)
    assert not _within(wrong, want, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cuda_flash_attention_counts_each_kernel(cuda, dtype):
    """bf16 moves only the tensor-core count, float32 only the CUDA-core
    one; ``launches`` is their sum."""
    q = torch.zeros((1, 2, 70, 64), device=cuda, dtype=dtype)
    before = (fa.tensor_core_launches, fa.cuda_core_launches, fa.launches)
    fa.flash_attention(q, q[:, :1].contiguous(), q[:, :1].contiguous())
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (fa.tensor_core_launches, fa.cuda_core_launches, fa.launches) == \
        (before[0] + tc, before[1] + 1 - tc, before[2] + 1)
