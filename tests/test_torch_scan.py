"""repro_torch linear_scan against the JAX reference.

The plain version of the port's ``linear_scan`` against the Pallas
kernel in interpret mode and against ``repro.kernels.ref.
linear_scan_ref``, for T = 1, ragged T and a given h0; the hand CUDA
kernel against its plain version where a card is present.

Tolerances: against the sequential ``linear_scan_ref``, 1e-6 absolute
(the same float32 steps; XLA may contract a step into one FMA).
Against the Pallas kernel, 1e-5 absolute: it runs an associative
prefix scan inside each time block, another summation order.  On the
card the kernel equals the plain version exactly: both take each step
as one rounded multiply and one rounded add.  The card's cases include
the serve path's prefill shapes, (8, 2304, 2560) and (1, 2048, 2560),
and D = 129 and 300, whose rows the kernel cannot copy in 16-byte
pieces.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import linear_scan as ls
from repro_torch.kernels import ops


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.linear_scan import linear_scan as jscan
    return types.SimpleNamespace(jnp=jnp, ref=jref, scan=jscan)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, b, t, d, with_h0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    a = rng.uniform(0.5, 1.0, (b, t, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32) if with_h0 else None
    return x, a, h0


def _port(x, a, h0):
    hs, last = ops.linear_scan(torch.from_numpy(x), torch.from_numpy(a),
                               None if h0 is None else torch.from_numpy(h0))
    assert last.dtype == torch.float32
    return hs.numpy(), last.numpy()


# (B, T, D, h0): T = 1 (a decode step), ragged T, with and without h0
CASES = [(2, 1, 16, True), (2, 1, 16, False), (3, 37, 24, True),
         (2, 300, 8, False), (1, 65, 128, True)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_linear_scan_ref(J, case):
    x, a, h0 = _inputs(sum(case[:3]), *case)
    hs, last = _port(x, a, h0)
    jh0 = None if h0 is None else J.jnp.asarray(h0)
    whs, wlast = J.ref.linear_scan_ref(J.jnp.asarray(x), J.jnp.asarray(a), jh0)
    np.testing.assert_allclose(hs, np.asarray(whs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(last, np.asarray(wlast), rtol=0, atol=1e-6)


@pytest.mark.parametrize("tt", [16, 256])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_pallas_interpret(J, case, tt):
    x, a, h0 = _inputs(sum(case[:3]), *case)
    hs, last = _port(x, a, h0)
    jh0 = None if h0 is None else J.jnp.asarray(h0)
    whs, wlast = J.scan(J.jnp.asarray(x), J.jnp.asarray(a), jh0, tt=tt,
                        interpret=True)
    np.testing.assert_allclose(hs, np.asarray(whs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(last, np.asarray(wlast), rtol=0, atol=1e-5)


def test_bf16_states_match_linear_scan_ref(J):
    """bf16 in: float32 carry, states rounded to bf16 once per step, as
    the reference does; the final state stays float32 in the port."""
    import ml_dtypes
    x, a, h0 = _inputs(5, 2, 40, 16, True)
    xb, ab = x.astype(ml_dtypes.bfloat16), a.astype(ml_dtypes.bfloat16)
    hs, last = ops.linear_scan(torch.from_numpy(xb.astype(np.float32)).bfloat16(),
                               torch.from_numpy(ab.astype(np.float32)).bfloat16(),
                               torch.from_numpy(h0))
    whs, wlast = J.ref.linear_scan_ref(J.jnp.asarray(xb), J.jnp.asarray(ab),
                                       J.jnp.asarray(h0))
    assert hs.dtype == torch.bfloat16 and last.dtype == torch.float32
    np.testing.assert_allclose(hs.float().numpy(),
                               np.asarray(whs).astype(np.float32), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(last.numpy(), np.asarray(wlast), rtol=0,
                               atol=1e-6)


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = ls.launches
    x = torch.zeros((1, 3, 4))
    ops.linear_scan(x, x)
    assert ls.launches == before


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError):
        ops.linear_scan(x, x[:, :2])
    with pytest.raises(TypeError):
        ops.linear_scan(x, x.double())
    with pytest.raises(ValueError):
        ops.linear_scan(x, x, torch.zeros((2, 3)))


# ---------------------------------------------------------------------------
# the hand CUDA kernel (runs only where a card is present)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", [(8, 1, 2560, True), (8, 1, 2560, False),
                                  (3, 77, 300, True), (2, 1000, 129, False),
                                  (1, 2048, 2560, False),
                                  (8, 2304, 2560, False),
                                  (1, 2048, 2560, True)], ids=str)
def test_cuda_linear_scan_matches_plain_exactly(cuda, case, dtype):
    x, a, h0 = (None if z is None else torch.from_numpy(z).to(cuda)
                for z in _inputs(sum(case[:3]), *case))
    x, a = x.to(dtype), a.to(dtype)
    before = ls.launches
    hs, last = ls.linear_scan(x, a, h0)
    phs, plast = ls.linear_scan_plain(x, a, h0)
    torch.cuda.synchronize()
    assert ls.launches == before + 1
    assert hs.dtype == dtype and last.dtype == torch.float32
    assert torch.equal(hs, phs) and torch.equal(last, plast)
