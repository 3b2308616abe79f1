"""Star patterns and the paper's counting formulas (Defs 4.4 - 4.8).

Given a class ``C`` with property set ``S`` and a candidate subset
``SP = {p_1..p_n}``:

* ``M(o_1..o_n | G)``   -- class multiplicity (Def. 4.5): number of distinct
  entities of C whose objects over SP equal the tuple ``(o_1..o_n)``.
* ``MI = 1/M``          -- class multiplicity inverse (Def. 4.6).
* ``AMI_G(SP|C)``       -- multiplicity of star patterns (Def. 4.7):
  ``ceil( sum over matching entities of MI )``.  With complete molecules and
  functional properties this equals the number of *distinct object tuples*,
  i.e. the number of star patterns over SP.
* ``#Edges(SP, C, G)``  -- the FSP-detection objective (Def. 4.8):

      AMI_G(SP|C) * (|SP| + 1)  +  AM_G(C) * |S - SP|

The detectors score SP on the entities its factorization folds
(:func:`folded_edges`): E(SP), C's entities with exactly one object for
every property of SP, AMI over them, and with n_p C's (e, p, o) rows,

      AMI * (|SP| + 1)  +  sum_{p in S} n_p  -  |E(SP)| * |SP|

against the baseline sum_{p in S} n_p.  Def. 4.8 is its case of a class
whose properties are all functional and complete (n_p = AM, E(SP) every
entity); elsewhere Def. 4.8 predicts savings the factorization cannot
make.

Both a numpy host path and a torch device path are provided.  The device
path works on fixed-shape object matrices on the tensor's own device:
row signature -> sort -> segment count, with the hand CUDA kernels on a
CUDA tensor and their plain versions on a CPU one (``kernels.ops``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import obs
from ..kernels import ops as kops
from .index import _run_starts, row_keys
from .triples import TripleStore

# ---------------------------------------------------------------------------
# host (numpy) path
# ---------------------------------------------------------------------------


def row_groups(objmat: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group identical rows of an (n, k) int matrix.

    Returns ``(group_of_row, group_counts, representative_row_index)``:
    ``group_of_row[i]`` is the group id of row i, ``group_counts[g]`` the
    multiplicity M of group g, ``representative_row_index[g]`` one row index
    instantiating group g.  Groups are numbered in the lexicographic order
    of their int32 rows; the representative is the group's first row.
    """
    return _row_groups(objmat)[:3]


def _row_groups(objmat: np.ndarray, with_order: bool = False):
    """:func:`row_groups`, and with ``with_order`` the row indices in
    group order, each group's rows in index order (else None).  The rows
    are keyed by ``index.row_keys``: one int64 where their column ranges
    fit, else a structured view of the row."""
    n = objmat.shape[0]
    if n == 0:
        z = np.empty((0,), np.int64)
        return z, z, z, z if with_order else None
    (key,) = row_keys(range(objmat.shape[1]), objmat)
    # an unstable sort, then each group's rows put back in index order by
    # one sort of (group, row) pairs packed in an int64 (n < 2**31)
    order = np.argsort(key)
    first = _run_starts(key[order])
    starts = np.flatnonzero(first)
    group = np.cumsum(first) - 1
    inv = np.empty(n, np.int64)
    inv[order] = group
    group <<= 31
    group |= order
    group.sort()
    order = group & (2**31 - 1)
    return (inv, np.diff(starts, append=n), order[starts],
            order if with_order else None)


def multiplicities(objmat: np.ndarray) -> np.ndarray:
    """Per-entity class multiplicity M (Def. 4.5) over the object matrix."""
    inv, counts, _ = row_groups(objmat)
    return counts[inv]


def ami(objmat: np.ndarray) -> int:
    """Multiplicity of star patterns AMI (Def. 4.7) = #distinct object rows.

    ``ceil(sum_i 1/M_i)`` equals the number of groups exactly (each group of
    size M contributes M * (1/M) = 1), so we count groups directly.
    """
    return int(row_groups(objmat)[1].shape[0])


def folded_edges(ami_value, n_e, n_sp, total):
    """#Edges(SP, C, G) scored on the entities SP folds: ``ami_value``
    molecules of ``n_sp`` arms and a type edge each, plus the class's
    ``total`` (e, p, o) rows over S less the ``n_e * n_sp`` arms of the
    ``n_e`` folded entities.  Elementwise over aligned ints, arrays or
    tensors."""
    return ami_value * (n_sp + 1) + total - n_e * n_sp


def num_edges(ami_value: int, am: int, n_sp: int, n_s: int) -> int:
    """#Edges(SP, C, G) -- Def. 4.8 / Formula 1: :func:`folded_edges` with
    every entity folded and ``AM * |S|`` rows."""
    am = int(am)
    return int(folded_edges(int(ami_value), am, n_sp, am * n_s))


@dataclasses.dataclass(frozen=True)
class StarSweepResult:
    """Evaluation of one candidate property subset."""

    props: tuple[int, ...]
    ami: int
    am: int
    n_total_props: int
    edges: int

    @property
    def is_single_pattern(self) -> bool:
        return self.ami == 1


def evaluate_subset(store: TripleStore, class_id: int,
                    props: Sequence[int], n_total_props: int,
                    am: int | None = None) -> StarSweepResult:
    """Compute AMI and #Edges for one (class, SP) candidate."""
    props = tuple(int(p) for p in props)
    ents, objmat = store.object_matrix(class_id, props)
    if am is None:
        am = int(store.entities_of_class(class_id).shape[0])
    a = ami(objmat)
    return StarSweepResult(
        props=props, ami=a, am=am, n_total_props=n_total_props,
        edges=num_edges(a, am, len(props), n_total_props))


def star_groups(store: TripleStore, class_id: int, props: Sequence[int]
                ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Materialized star patterns over SP: list of (entities, object_row).

    Each element is one star pattern (Def. 4.4): the entities matching it and
    the shared object tuple.  This is what Algorithm 3 consumes.
    """
    props = np.asarray(list(props), dtype=np.int32)
    with obs.span("star_groups") as sp:
        ents, objmat = store.object_matrix(class_id, props)
        inv, counts, rep, order = _row_groups(objmat, with_order=True)
        boundaries = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64)
        sorted_ents = ents[order]
        sp.set(groups=int(counts.shape[0]))
        return [(sorted_ents[boundaries[g]:boundaries[g + 1]],
                 objmat[rep[g]]) for g in range(counts.shape[0])]


# ---------------------------------------------------------------------------
# device (torch) path
# ---------------------------------------------------------------------------

def ami_device(objmat: torch.Tensor, valid: torch.Tensor | None = None
               ) -> torch.Tensor:
    """AMI on the tensor's device: #distinct rows of ``objmat`` (n, k)
    int32, as a 0-d int32 tensor.

    ``valid``: optional (n,) bool mask of rows to count; the others get
    the sentinel signature inside ``kops.row_signature`` and their one
    segment is subtracted here.  Collision probability over two
    independent 32-bit mixes is ~n^2 / 2^64.
    """
    sig = kops.row_signature(objmat, valid=valid)          # (n, 2) uint32
    sig_sorted, _ = kops.sort_signatures(sig)
    _, n_groups = kops.seg_boundaries(sig_sorted)
    if valid is not None:
        return n_groups - (~valid).any().to(torch.int32)
    return n_groups


def ami_device_batch(mats: torch.Tensor, valid: torch.Tensor | None = None,
                     col_masks: torch.Tensor | None = None) -> torch.Tensor:
    """AMI for a whole candidate stack -> (C,) int32.

    ``mats`` is a (C, N, K) int32 stack, or -- with ``col_masks`` (C, K)
    -- the (N, K) parent whose masked copies the signature kernel hashes
    without materializing them.  One signature launch, one batched sort,
    one batched segment count.  ``valid`` is (N,) (shared bucket padding)
    or (C, N); each candidate's sentinel segment is subtracted on its own.
    """
    sig = kops.row_signature(mats, valid=valid, col_masks=col_masks)
    sig_sorted, _ = kops.sort_signatures(sig)                # (C, N, 2)
    _, n_groups = kops.seg_boundaries(sig_sorted)            # (C,)
    if valid is not None:
        return n_groups - (~valid).any(dim=-1).to(torch.int32)
    return n_groups


def multiplicities_device(objmat: torch.Tensor,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row multiplicity M on the tensor's device (sort + segment
    length + unsort), (n,) int32.

    ``valid``: optional padding mask, same convention as :func:`ami_device`
    (invalid rows collapse into one sentinel group whose multiplicity the
    caller must ignore)."""
    n = objmat.shape[0]
    sig = kops.row_signature(objmat, valid=valid)
    sig_sorted, order = kops.sort_signatures(sig)
    new_seg, _ = kops.seg_boundaries(sig_sorted)
    seg_id = torch.cumsum(new_seg, dim=0) - 1             # group of sorted row
    seg_count = torch.bincount(seg_id, minlength=n)
    out = torch.empty((n,), dtype=torch.int32, device=objmat.device)
    out[order] = seg_count[seg_id].to(torch.int32)         # unsort
    return out


def edges_formula_device(ami_value, am, n_sp, n_s):
    """Def. 4.8 on tensors (or ints): ``AMI * (|SP| + 1) + AM * |S - SP|``,
    elementwise where its arguments are aligned stacks."""
    return folded_edges(ami_value, am, n_sp, am * n_s)
