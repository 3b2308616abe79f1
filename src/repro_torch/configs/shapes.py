"""Input shapes of the LM family, plain data: each dry-run cell is
(arch x shape).  The port's copy of ``repro/configs/shapes.py``.

  train_4k     seq_len=4,096   global_batch=256   -> train_step
  prefill_32k  seq_len=32,768  global_batch=32    -> serve prefill
  decode_32k   seq_len=32,768  global_batch=128   -> serve_step (1 new token,
                                                     KV/state cache = seq_len)
  long_500k    seq_len=524,288 global_batch=1     -> serve_step; requires a
                sub-quadratic arch (SSM / hybrid) -- full-attention archs are
                skipped.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Kind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Kind


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; returns (ok, reason)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("SKIP: long_500k needs sub-quadratic attention; "
                       f"{cfg.name} has global full attention")
    return True, ""
