"""The yardstick of the kernels: the H100's peaks and the work each
launch of ``sig_hash`` and ``seg_count`` has to do.

The peaks are the numbers of ``src/repro_torch/launch/mesh.py`` (NVIDIA's
data sheet, H100 SXM, 700 W), kept here so a change to the program
cannot move them.  The work counts follow ``chip_smoke.py``
``kernel_times``, with one change: they count the class's true sizes
(the valid rows N, each candidate's K_c columns, the C real candidates)
and not the padded bucket, so a change to the bucket ladder moves the
kernel's time and not its bound.
"""
from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12                      # fused multiply-add as two
INT32_PIPE_OPS_PER_S = F32_FLOPS / 2 / 2


@dataclasses.dataclass(frozen=True)
class SigLaunch:
    """One signature launch: ``n`` valid rows, the columns each real
    candidate hashes, and the columns any of them reads."""

    n: int
    cand_cols: tuple[int, ...]
    union_cols: int

    @property
    def c(self) -> int:
        return len(self.cand_cols)


def sig_hash_bound_s(w: SigLaunch) -> float:
    """Least time of a launch: per valid row and candidate ``7K + 4``
    IMADs and ``7K + 14`` INT32 ops (murmur3 over K columns, both lanes,
    and the finish), against one read of the rows' used columns, their
    valid flags and the masks, and one 8-byte signature written per row
    and candidate; the larger of the two."""
    imad = sum(w.n * (7 * k + 4) for k in w.cand_cols)
    alu = sum(w.n * (7 * k + 14) for k in w.cand_cols)
    nbytes = (w.n * w.union_cols * 4 + w.n + w.c * w.union_cols * 4
              + w.c * w.n * 8)
    return max(nbytes / HBM_BYTES_PER_S,
               max(imad, alu) / INT32_PIPE_OPS_PER_S)


def seg_count_bound_s(n: int, c: int) -> float:
    """Least time of a segment count over ``c`` candidates' ``n`` sorted
    valid signatures: 8 bytes read and a 4-byte flag written per row,
    one count per candidate, and one compare per row."""
    nbytes = c * n * 8 + c * n * 4 + c * 4
    ops = c * n * 4
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_PIPE_OPS_PER_S)
