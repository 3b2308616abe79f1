"""Config registry: the architectures the port can run (``--arch``)."""
from __future__ import annotations

from . import recurrentgemma_2b
from .base import ArchConfig, reduced  # noqa: F401

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (recurrentgemma_2b,)
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port runs: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]
