"""Shared model components: parameter specs and their init, norms, rope.

The port's copy of ``repro/models/common.py`` without sharding hints or
the cross-entropy (serving needs neither).  A :class:`TSpec` names a
parameter's shape, dtype and init; :class:`SpecModule` turns a dict of
them into ``nn.Parameter``s under the JAX package's names, so the JAX
param tree maps onto ``state_dict`` keys one for one.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class TSpec:
    """Tensor spec: shape, dtype and init (normal | scaled | zeros | ones)."""
    shape: tuple[int, ...]
    dtype: str = "bfloat16"
    init: str = "normal"


class SpecModule(nn.Module):
    """A module whose parameters are declared by a ``{name: TSpec}`` dict.

    Parameters are allocated uninitialized on ``device``; the LM fills
    them with :func:`init_from_specs` or loads them (``load_state_dict``).
    They never take gradients: the port serves, it does not train yet.
    """

    def __init__(self, specs: dict[str, TSpec], device: torch.device):
        super().__init__()
        self.specs = specs
        for name, s in specs.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                            device=device), requires_grad=False))


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
