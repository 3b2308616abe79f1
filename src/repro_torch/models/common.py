"""Shared model components: parameter specs and their init, norms, rope,
the fused cross-entropy.

The port's copy of ``repro/models/common.py`` without sharding hints.  A
:class:`TSpec` names a parameter's shape, dtype, logical axes and init;
:class:`SpecModule` turns a dict of them into ``nn.Parameter``s under
the JAX package's names, so the JAX param tree maps onto ``state_dict``
keys one for one.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class TSpec:
    """Tensor spec: shape, dtype, logical sharding axes (one per dim, or
    none) and init (normal | scaled | zeros | ones).

    Logical axes vocabulary: "vocab", "embed", "ff", "heads", "experts",
    "layers", "rnn", "batch", "seq", "hd", None.  ``dist/sharding.py``
    maps them to mesh axes per config.  The port keeps one tensor per
    layer, so its specs carry no "layers" axis: each equals its JAX
    twin's with that leading axis stripped.
    """
    shape: tuple[int, ...]
    dtype: str = "bfloat16"
    axes: tuple[str | None, ...] = ()
    init: str = "normal"

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} rank != shape {self.shape}")


class SpecModule(nn.Module):
    """A module whose parameters are declared by a ``{name: TSpec}`` dict.

    Parameters are allocated uninitialized on ``device``; the LM fills
    them with :func:`init_from_specs` or loads them (``load_state_dict``).
    They take gradients (training); the serve entry points run under
    ``no_grad``.
    """

    def __init__(self, specs: dict[str, TSpec], device: torch.device):
        super().__init__()
        self.specs = specs
        for name, s in specs.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                            device=device)))


@torch.no_grad()
def init_from_specs(module: nn.Module, generator: torch.Generator,
                    base_scale: float = 0.02) -> None:
    """Fill every :class:`SpecModule` below ``module`` as the JAX
    ``init_from_specs`` does: normal * 0.02 drawn in float32 then cast,
    "scaled" normal * 0.01, zeros, ones.  Draws follow
    ``named_modules`` order from ``generator``."""
    for _, mod in module.named_modules():
        if not isinstance(mod, SpecModule):
            continue
        for name, spec in mod.specs.items():
            p = getattr(mod, name)
            if spec.init == "zeros":
                p.zero_()
            elif spec.init == "ones":
                p.fill_(1.0)
            else:
                scale = base_scale * (0.5 if spec.init == "scaled" else 1.0)
                p.copy_(torch.randn(spec.shape, generator=generator,
                                    dtype=torch.float32,
                                    device=p.device) * scale)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the ``1 + w`` scale, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding on split halves.  x: (B, T, H, hd); positions:
    (B, T) int."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs          # (B, T, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# the fused cross-entropy
# ---------------------------------------------------------------------------

# rows of logits per step of the fused cross-entropy: at most this many
# float32 elements of one step's temporaries (256 MiB)
CE_CHUNK_ELEMS = 1 << 26


def causal_cross_entropy_ref(logits: torch.Tensor, labels: torch.Tensor,
                             mask: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Reference CE (materializes float32 logits; the test oracle)."""
    lf = logits.float()
    nll = torch.logsumexp(lf, -1) - torch.gather(
        lf, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _row_chunks(n: int, v: int):
    step = max(1, CE_CHUNK_ELEMS // max(v, 1))
    return [(i, min(i + step, n)) for i in range(0, n, step)]


class _FusedCE(torch.autograd.Function):
    """The JAX ``_fused_ce``: loss = sum((lse - gold) * mask) / max(sum
    mask, 1), its gradient ``(softmax - onehot) * mask * g / denom`` in
    the logits' type.  Both passes walk the (N, V) rows in chunks of
    :data:`CE_CHUNK_ELEMS`, so no float32 copy of the logits exists
    (qwen2-0.5b's (8, 4096, 151936) would take 19.9 GB)."""

    @staticmethod
    def forward(ctx, logits, labels, mask):
        v = logits.shape[-1]
        lg = logits.reshape(-1, v)
        lab = labels.reshape(-1).long()
        mk = mask.reshape(-1)
        lse = torch.empty(lg.shape[0], dtype=torch.float32,
                          device=logits.device)
        gold = torch.empty_like(lse)
        for i0, i1 in _row_chunks(lg.shape[0], v):
            rows = lg[i0:i1]
            m = rows.amax(-1).float()                  # max exact in bf16
            z = torch.exp(rows.float() - m[:, None]).sum(-1)
            lse[i0:i1] = m + torch.log(z)
            gold[i0:i1] = torch.gather(rows, 1, lab[i0:i1, None])[:, 0].float()
        denom = torch.clamp(mk.sum(), min=1.0)
        loss = ((lse - gold) * mk).sum() / denom
        ctx.save_for_backward(logits, labels, mask, lse, denom)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, mask, lse, denom = ctx.saved_tensors
        v = logits.shape[-1]
        lg = logits.reshape(-1, v)
        lab = labels.reshape(-1).long()
        scale = mask.reshape(-1) * (g / denom)
        dl = torch.empty_like(lg)
        for i0, i1 in _row_chunks(lg.shape[0], v):
            p = torch.exp(lg[i0:i1].float() - lse[i0:i1, None])
            sc = scale[i0:i1]
            dl[i0:i1] = p.mul_(sc[:, None])
            # the onehot as a scatter of -scale at the labels, in the
            # logits' type (the JAX ``.at[...].add``)
            dl[i0:i1].scatter_add_(1, lab[i0:i1, None],
                                   (-sc).to(dl.dtype)[:, None])
        return dl.reshape(logits.shape), None, None


def causal_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE over ``mask`` (default: every position);
    logits (B, T, V) in any float type, labels (B, T) int.  The fused
    forward and backward keep dlogits in the logits' type."""
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    return _FusedCE.apply(logits, labels, mask.float())
