"""Command-line entry points of the port."""
from __future__ import annotations

import torch

from ..configs import ArchConfig, get_arch, reduced

# the smallest head size the flash kernels are built for
CARD_HEAD_DIM = 64

REDUCED_HELP = ("the tiny float32 same-family config: the JAX launcher's "
                "reduced(cfg) exactly on the CPU; on the card the same "
                f"with head_dim {CARD_HEAD_DIM}, the flash kernels' "
                "smallest head size")


def arch_config(arch: str, *, reduced_cfg: bool, device) -> ArchConfig:
    """The config a launcher runs for ``--arch``/``--reduced`` on
    ``device``: the published one; or with ``reduced_cfg`` JAX's
    ``reduced(cfg)`` on the CPU (so the same argv builds the same model
    as the JAX launcher there) and ``reduced(cfg, head_dim=64)`` on the
    card, where no flash kernel is built at JAX's head_dim 32.  Nothing
    is allocated and the device is not opened."""
    cfg = get_arch(arch)
    if not reduced_cfg:
        return cfg
    if torch.device(device).type == "cuda":
        return reduced(cfg, head_dim=CARD_HEAD_DIM)
    return reduced(cfg)
