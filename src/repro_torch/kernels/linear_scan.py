"""Diagonal linear recurrence: the hand CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/linear_scan.py::
linear_scan`` (``_scan_kernel``).  The kernel is ``csrc/linear_scan.cu``:
one thread per (batch, channel) with a float32 carry in a register
walking the T steps, one warp of 32 neighbouring channels per block, and
a ring of 4 cp.async stages (32 time steps x 32 channels of x and a
each) filled 3 stages ahead of the chain.

What bounds it on an H100: bytes -- x and a read once, the states
written once.  At recurrentgemma-2b's prefill (8, 2304, 2560) float32
that is 566 MB, 0.169 ms at 3.35 TB/s.  With only 20,480 chains, the
ring's bytes in flight, not the thread count, have to cover the memory
latency.

The states leave in x's type and the final state in float32 (the port's
stated choice: ``linear_scan_ref`` and the float32 RG-LRU state cache
agree; the Pallas wrapper casts the final state to x's type).  Each step
is one rounded multiply then one rounded add in both versions, so the
kernel equals :func:`linear_scan_plain` bit for bit.

Dispatch goes by the tensor's device: a CPU tensor runs
:func:`linear_scan_plain`, a CUDA tensor launches the kernel (or raises),
and a ``meta`` tensor (the dry run) goes through :data:`meta_op`, empty
outputs of the right shapes standing for the kernel's own work
(:func:`work`).  ``launches`` counts kernel launches and nothing else.

Training goes through :func:`linear_scan_autograd`, a
``torch.autograd.Function`` around the same wrapper.  Its backward is
itself a linear scan, run in reverse: ``g_t = dhs_t + a_{t+1} g_{t+1}``
seeded with the final state's gradient (``a_T = 1``), then ``dx = g``,
``da_t = g_t h_{t-1}`` (``h_{-1} = h0``, or 0) and ``dh0 = a_0 g_0``.
So on the card the backward launches the same kernel on the reversed,
shifted inputs, in float32; on the CPU it runs the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(x, a, h0):
    if x.ndim != 3 or a.shape != x.shape:
        raise ValueError(f"expected x = a (B, T, D), got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}")
    if x.dtype != a.dtype or not x.dtype.is_floating_point:
        raise TypeError(f"x and a must share one float type, got {x.dtype}, "
                        f"{a.dtype}")
    if h0 is not None and (tuple(h0.shape) != (x.shape[0], x.shape[2])
                           or not h0.dtype.is_floating_point):
        raise ValueError(f"h0 must be float ({x.shape[0]}, {x.shape[2]}), "
                         f"got {tuple(h0.shape)} {h0.dtype}")


def work(x_shape, dtype: torch.dtype, has_h0: bool) -> tuple[int, int]:
    """(flops, bytes) the kernel must do for one call: a multiply and an
    add per element and step; x and a read once, the states written
    once, the float32 final state written (and h0 read).
    ``chip_smoke.py``'s bound and the dry run's count read this."""
    b, _, d = x_shape
    n = int(np.prod(x_shape))
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * n, 3 * n * itemsize + 4 * b * d * (2 if has_h0 else 1)


@torch.library.custom_op("repro_torch::linear_scan", mutates_args=())
def meta_op(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's stand-in on ``meta`` tensors."""
    raise NotImplementedError("linear_scan's meta op runs on meta tensors "
                              "only")


@meta_op.register_fake
def _(x, a, h0):
    return torch.empty_like(x), x.new_empty((x.shape[0], x.shape[2]),
                                            dtype=torch.float32)


def linear_scan_plain(x: torch.Tensor, a: torch.Tensor,
                      h0: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, in plain torch (a loop over T).  Same
    arguments and result as :func:`linear_scan`."""
    _check_args(x, a, h0)
    return ref.linear_scan_ref(x, a, h0)


def linear_scan(x: torch.Tensor, a: torch.Tensor,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, a: (B, T, D); h0: (B, D) or None -> ((B, T, D) states in x's
    type, (B, D) float32 final state).

    On CUDA: x and a float32 or bfloat16, contiguous; h0 is taken as
    float32.
    """
    global launches
    if x.device.type == "cpu":
        return linear_scan_plain(x, a, h0)
    if x.device.type == "meta":
        _check_args(x, a, h0)
        return meta_op(x, a, h0)
    if x.device.type != "cuda":
        raise ValueError(f"linear_scan runs on cpu, cuda or meta, not "
                         f"{x.device}")
    _check_args(x, a, h0)
    if x.dtype not in _DTYPES:
        raise TypeError(f"linear_scan kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if h0 is not None:
        h0 = h0.float().contiguous()
    for name, t in (("x", x), ("a", a), ("h0", h0)):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"linear_scan: {name} must be contiguous on "
                             f"{x.device}")
    b, t, d = x.shape
    if b > 65535:
        raise ValueError(f"linear_scan takes B <= 65535, got {b}")
    hs = torch.empty_like(x)
    last = torch.empty((b, d), dtype=torch.float32, device=x.device)
    if b == 0 or d == 0:
        return hs, last
    if t == 0:
        return hs, (last.zero_() if h0 is None else h0.clone())
    from .build import check, library
    err = library().repro_linear_scan(
        x.data_ptr(), a.data_ptr(), h0.data_ptr() if h0 is not None else None,
        hs.data_ptr(), last.data_ptr(), b, t, d, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "linear_scan")
    launches += 1
    return hs, last


def linear_scan_bwd(a: torch.Tensor, hs: torch.Tensor,
                    h0: torch.Tensor | None, dhs: torch.Tensor,
                    dlast: torch.Tensor, x_dtype: torch.dtype):
    """(dx, da, dh0) of ``linear_scan`` from the forward's ``a``, states
    ``hs`` and ``h0`` and the gradients of its two outputs: one reverse
    scan through :func:`linear_scan` (the kernel on CUDA) in float32."""
    b, t, d = a.shape
    af = a.float()
    a_rev = torch.cat([af[:, 1:], torch.ones((b, 1, d), dtype=torch.float32,
                                             device=a.device)], dim=1)
    g_rev, _ = linear_scan(dhs.float().flip(1).contiguous(),
                           a_rev.flip(1).contiguous(),
                           dlast.float().contiguous())
    g = g_rev.flip(1)
    first = (torch.zeros((b, 1, d), dtype=torch.float32, device=a.device)
             if h0 is None else h0.float()[:, None])
    h_prev = torch.cat([first, hs[:, :-1].float()], dim=1)
    dh0 = None if h0 is None else (af[:, 0] * g[:, 0]).to(h0.dtype)
    return g.to(x_dtype), (g * h_prev).to(a.dtype), dh0


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, h0):
        hs, last = linear_scan(x, a, h0)
        ctx.save_for_backward(a, hs, h0)
        ctx.x_dtype = x.dtype
        return hs, last

    @staticmethod
    def backward(ctx, dhs, dlast):
        a, hs, h0 = ctx.saved_tensors
        return linear_scan_bwd(a, hs, h0, dhs, dlast, ctx.x_dtype)


def linear_scan_autograd(x: torch.Tensor, a: torch.Tensor,
                         h0: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`linear_scan` that autograd can differentiate: the
    :class:`_LinearScan` Function when a gradient is needed, else the
    wrapper alone (nothing saved)."""
    if torch.is_grad_enabled() and any(
            u is not None and u.requires_grad for u in (x, a, h0)):
        return _LinearScan.apply(x, a, h0)
    return linear_scan(x, a, h0)
