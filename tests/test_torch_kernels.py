"""repro_torch kernels against the JAX reference: the plain torch
versions against ``repro.kernels.ref`` and the Pallas kernels (interpret
mode), bit for bit; the hand CUDA kernels against their plain versions
where a card is present.

The JAX package is imported inside the ``J`` fixture, so on a machine
with a card and no jax (``python -m pytest -m cuda`` there) this file
still imports and the CUDA cases run; the reference cases skip there.
"""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.seg_count import seg_boundaries, seg_boundaries_plain
from repro_torch.kernels.sig_hash import sig_hash, sig_hash_plain


def _rows(rng, shape):
    """int32 rows over the full range, with -1 pad rows and repeats."""
    x = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    x[..., ::5, :] = -1
    if shape[-2] > 3:
        x[..., 1::7, :] = x[..., 2:3, :]
    return x


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


@pytest.fixture(scope="module")
def J():
    """The JAX reference: ``repro.kernels`` plus jitted helpers (one
    compiled program per shape instead of one per eager primitive)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.seg_count import seg_boundaries
    from repro.kernels.sig_hash import sig_hash
    return types.SimpleNamespace(
        jnp=jnp, ops=jops, ref=jref, pallas_sig_hash=sig_hash,
        pallas_seg_boundaries=seg_boundaries,
        seg=jax.jit(jref.seg_boundaries_ref),
        sig=jax.jit(functools.partial(jops.row_signature, use_kernel=False)),
        sort=jax.jit(jops.sort_signatures))


_STACKS: dict = {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# row signatures
# ---------------------------------------------------------------------------

def _stack_and_reference(J, k: int):
    """A (3, 1025, k) stack and the reference's signatures of it.  Rows
    hash independently, so every (n, k) / (3, n, k) case below is a
    slice of this one reference call."""
    if k not in _STACKS:
        x = _rows(np.random.default_rng(k), (3, 1025, k))
        _STACKS[k] = (x, np.asarray(J.ref.row_signature_ref(J.jnp.asarray(x))))
    return _STACKS[k]


@pytest.mark.parametrize("n", [1, 63, 1025])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 32])
@pytest.mark.parametrize("batched", [False, True])
def test_row_signature_ref_matches_reference(J, n, k, batched):
    stack, want = _stack_and_reference(J, k)
    sl = (slice(None), slice(0, n)) if batched else (0, slice(0, n))
    x = np.ascontiguousarray(stack[sl])
    got = ops.row_signature(torch.from_numpy(x))
    assert got.dtype == torch.uint32 and tuple(got.shape) == x.shape[:-1] + (2,)
    np.testing.assert_array_equal(_np(got), want[sl])


@pytest.mark.parametrize("shape", [(1, 1), (63, 3), (1025, 8), (2, 63, 2),
                                   (3, 1025, 32)])
def test_row_signature_matches_pallas_interpret(J, shape):
    rng = np.random.default_rng(sum(shape))
    x = _rows(rng, shape)
    got = ref.row_signature_ref(torch.from_numpy(x))
    want = np.asarray(J.pallas_sig_hash(J.jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("valid_shape", ["none", "n", "cn"])
@pytest.mark.parametrize("k", [3, 8])
def test_fused_col_masks_match_masked_stack(J, valid_shape, k):
    """row_signature(parent, valid, col_masks) == the reference hashing
    the materialized (C, N, K) masked stack, sentinel included."""
    rng = np.random.default_rng(k)
    n, c = 100, 4
    parent = _rows(rng, (n, k))
    masks = rng.integers(0, 2, (c, k)).astype(np.int32)
    masks[0] = 0                                   # all-masked candidate
    valid = {"none": None, "n": rng.random(n) < 0.8,
             "cn": rng.random((c, n)) < 0.8}[valid_shape]
    got = ops.row_signature(
        torch.from_numpy(parent),
        valid=None if valid is None else torch.from_numpy(valid),
        col_masks=torch.from_numpy(masks))
    stack = J.jnp.asarray(parent[None] * masks[:, None, :])
    jv = None if valid is None else J.jnp.asarray(valid)
    want = np.asarray(J.sig(stack, valid=jv))
    np.testing.assert_array_equal(_np(got), want)
    want_k = np.asarray(J.ops.row_signature(stack, valid=jv, use_kernel=True))
    np.testing.assert_array_equal(_np(got), want_k)


@pytest.mark.parametrize("batched", [False, True])
def test_sentinel_rows(J, batched):
    rng = np.random.default_rng(3)
    x = _rows(rng, (2, 50, 4) if batched else (50, 4))
    valid = rng.random(x.shape[:-1]) < 0.5
    got = _np(ops.row_signature(torch.from_numpy(x),
                                valid=torch.from_numpy(valid)))
    want = np.asarray(J.sig(J.jnp.asarray(x), valid=J.jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == ref.SIG_SENTINEL).all()


# ---------------------------------------------------------------------------
# sort + segment boundaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2), (300, 2), (4, 300, 2)])
def test_sort_signatures_matches_lexsort(J, shape):
    rng = np.random.default_rng(shape[0])
    # few distinct lane values (many ties) plus the sentinel and the
    # top bit set, where signed and unsigned order differ
    pool = np.asarray([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    sig = pool[rng.integers(0, len(pool), shape)]
    got, order = ops.sort_signatures(torch.from_numpy(sig))
    want, want_order = J.sort(J.jnp.asarray(sig))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))


@pytest.mark.parametrize("n", [1, 2, 63, 2049])
@pytest.mark.parametrize("batched", [False, True])
def test_seg_boundaries_matches_reference(J, n, batched):
    rng = np.random.default_rng(n)
    sig = rng.integers(0, 4, ((3, n, 2) if batched else (n, 2))
                       ).astype(np.uint32)
    sig = np.array(J.sort(J.jnp.asarray(sig))[0])
    bounds, counts = ops.seg_boundaries(torch.from_numpy(sig))
    want = np.asarray(J.seg(J.jnp.asarray(sig)))
    np.testing.assert_array_equal(bounds.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), want.sum(axis=-1))


@pytest.mark.parametrize("shape", [(2049, 2), (3, 63, 2)])
def test_seg_boundaries_matches_pallas_interpret(J, shape):
    rng = np.random.default_rng(shape[0])
    sig = np.array(J.sort(J.jnp.asarray(
        rng.integers(0, 4, shape).astype(np.uint32)))[0])
    bounds, counts = ops.seg_boundaries(torch.from_numpy(sig))
    pb, pc = J.pallas_seg_boundaries(J.jnp.asarray(sig), interpret=True)
    np.testing.assert_array_equal(bounds.numpy(), np.asarray(pb))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(pc))


def test_wrappers_reject_bad_arguments():
    x = torch.zeros((4, 3), dtype=torch.int64)
    with pytest.raises(TypeError):
        sig_hash(x)
    with pytest.raises(ValueError):
        sig_hash(x.to(torch.int32), valid=torch.ones(5, dtype=torch.bool))
    with pytest.raises(ValueError):
        sig_hash(x.to(torch.int32), col_masks=torch.ones((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        seg_boundaries(torch.zeros((4, 2), dtype=torch.int32))


def test_cpu_tensors_take_the_plain_version_without_launching():
    from repro_torch.kernels import seg_count as sc, sig_hash as sh
    before = (sh.launches, sc.launches)
    sig = sig_hash(torch.zeros((8, 2), dtype=torch.int32))
    seg_boundaries(ops.sort_signatures(sig)[0])
    assert (sh.launches, sc.launches) == before


# ---------------------------------------------------------------------------
# the hand CUDA kernels (run only where a card is present)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 70001])
@pytest.mark.parametrize("k", [2, 3, 8, 32])
def test_cuda_sig_hash_matches_plain(cuda, n, k):
    rng = np.random.default_rng(n + k)
    parent = torch.from_numpy(_rows(rng, (n, k))).to(cuda)
    stack = torch.from_numpy(_rows(rng, (3, n, k))).to(cuda)
    masks = torch.from_numpy(rng.integers(0, 2, (3, k)).astype(np.int32)
                             ).to(cuda)
    v_n = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    v_cn = torch.from_numpy(rng.random((3, n)) < 0.9).to(cuda)
    for args, kw in [((parent,), {}), ((parent,), {"valid": v_n}),
                     ((stack,), {"valid": v_cn}),
                     ((parent,), {"valid": v_n, "col_masks": masks}),
                     ((parent,), {"valid": v_cn, "col_masks": masks})]:
        got = sig_hash(*args, **kw)
        want = sig_hash_plain(*args, **kw)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 70001])
def test_cuda_seg_count_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    sig = torch.from_numpy(rng.integers(0, 3, (3, n, 2)).astype(np.uint32)
                           ).to(cuda)
    srt, _ = ops.sort_signatures(sig)
    for s in (srt, srt[0].contiguous()):
        b, c = seg_boundaries(s)
        pb, pc = seg_boundaries_plain(s)
        assert torch.equal(b, pb) and torch.equal(c, pc)
