"""Config registry: the architectures the port can run (``--arch``)."""
from __future__ import annotations

from . import (dbrx_132b, internvl2_2b, llama3_2_1b, llama3_405b,
               mamba2_780m, moonshot_v1_16b_a3b, qwen2_0_5b, qwen3_32b,
               recurrentgemma_2b, whisper_medium)
from .base import ArchConfig, reduced  # noqa: F401

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_0_5b, llama3_2_1b, qwen3_32b, llama3_405b, mamba2_780m,
              recurrentgemma_2b, moonshot_v1_16b_a3b, dbrx_132b,
              whisper_medium, internvl2_2b)
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port runs: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]
