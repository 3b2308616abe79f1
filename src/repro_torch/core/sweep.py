"""Shape-bucketed, candidate-batched sweep workspaces: the detectors'
hot loop.

A :class:`SweepWorkspace` holds one class's descent:

* **one extraction per class**: the object matrix over the *full*
  property set S is pulled through the ``GraphIndex`` joins once; every
  candidate evaluation -- on every backend -- is a column selection of
  that parent matrix.
* **one upload per class**: the device workspace ships the bucket-padded
  ``(n_b, k_b)`` int32 parent to the device on its first sweep; every
  batch after that ships only the ``(c_b, k_b)`` mask stack.
* **one launch sequence per candidate batch**: ``sweep_candidates``
  evaluates an arbitrary stack of C column-mask candidates with one
  signature launch (the mask applied inside the kernel, so the masked
  ``(c, n, k)`` stack is never materialized), one batched sort and one
  segment-count launch, and one device -> host copy of the result.
  The drop-one sweep is the C = |SP| special case, and E.FSP feeds each
  whole subset level through it.
* **one shape per bucket**: ``(n, k, c)`` pads up to a power-of-two
  bucket (rows carry a validity mask, columns a zero mask, padding
  candidates are all-zero no-ops).  Masking a column to zero is
  AMI-exact: the column contributes the same constant to every row's
  signature.  PyTorch runs eagerly, so a "trace" here is the first
  launch of a given ``(n_b, k_b, c_b)`` shape; ``TRACE_COUNTS`` records
  one entry per such shape, and ``EXEC_STATS`` counts launched batches
  ("lowerings") against logical sweeps ("descents").
"""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from .star import (StarSweepResult, ami, ami_device_batch, num_edges,
                   num_edges_batch)
from .triples import TripleStore

# -- bucket ladder -----------------------------------------------------------

BUCKET_MIN_ROWS = 64    # floor: tiny classes share one bucket shape
BUCKET_MIN_COLS = 2     # star patterns need >= 2 properties
BUCKET_MIN_CANDS = 2    # candidate-axis floor (mirrors the column floor)

# one batch evaluates at most this many candidates; larger stacks are
# chunked so the (c_b, n_b, 2) signature stack stays bounded
MAX_SWEEP_CANDIDATES = 256


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def bucket_rows(n: int) -> int:
    """Row bucket: next power of two >= max(n, floor)."""
    return max(_next_pow2(n), BUCKET_MIN_ROWS)


def bucket_cols(k: int) -> int:
    return max(_next_pow2(k), BUCKET_MIN_COLS)


def bucket_candidates(c: int) -> int:
    """Candidate-axis bucket: next power of two, floored at 2, capped by
    chunking at ``MAX_SWEEP_CANDIDATES`` (callers slice larger stacks)."""
    return max(_next_pow2(min(c, MAX_SWEEP_CANDIDATES)), BUCKET_MIN_CANDS)


# -- shape / execution accounting ---------------------------------------------

TRACE_COUNTS: dict[tuple, int] = {}

# ``descents`` counts logical sweep calls, ``lowerings`` launched batches
# -- the batched engine keeps their ratio at 1 for any candidate stack
# that fits one chunk
EXEC_STATS = {"lowerings": 0, "descents": 0}

# (kind, shape) pairs launched at least once since the last
# clear_compile_cache(): the eager counterpart of a jit cache
_SEEN_SHAPES: set[tuple] = set()


def _note_trace(kind: str, shape: tuple) -> None:
    """Record the first launch of ``(kind, shape)`` in ``TRACE_COUNTS``."""
    key = (kind,) + tuple(int(x) for x in shape)
    if key in _SEEN_SHAPES:
        return
    _SEEN_SHAPES.add(key)
    TRACE_COUNTS[key] = TRACE_COUNTS.get(key, 0) + 1


def reset_trace_stats() -> None:
    TRACE_COUNTS.clear()
    EXEC_STATS["lowerings"] = 0
    EXEC_STATS["descents"] = 0


def clear_compile_cache() -> None:
    """Forget every launched shape AND the counters -- a deterministic
    cold start regardless of process history."""
    _SEEN_SHAPES.clear()
    reset_trace_stats()


def trace_count() -> int:
    """Total first launches of a bucket shape since the last reset."""
    return sum(TRACE_COUNTS.values())


def distinct_bucket_shapes() -> int:
    return len(TRACE_COUNTS)


def lowerings_per_descent() -> float:
    """Launched batches per logical sweep since the last reset (0.0 on
    the host path, which launches nothing)."""
    d = EXEC_STATS["descents"]
    return EXEC_STATS["lowerings"] / d if d else 0.0


# -- the bucket sweep ----------------------------------------------------------

def bucket_sweep(parent: torch.Tensor, valid: torch.Tensor,
                 col_masks: torch.Tensor, am: int, n_s: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(edges, amis) of a ``(c_b, k_b)`` 0/1 candidate stack over the
    ``(n_b, k_b)`` parent, both (c_b,) int64 on the parent's device."""
    _note_trace("sweep", tuple(parent.shape) + (col_masks.shape[0],))
    amis = ami_device_batch(parent, valid=valid,
                            col_masks=col_masks).to(torch.int64)
    n_sp = col_masks.sum(dim=1, dtype=torch.int64)
    edges = amis * (n_sp + 1) + am * (n_s - n_sp)
    return edges, amis


# -- selection rule ----------------------------------------------------------

def pick_child(current: StarSweepResult, edges: np.ndarray,
               amis: np.ndarray, n_s: int, am: int
               ) -> tuple[StarSweepResult, int]:
    """Shared selection rule: first AMI == 1 candidate (paper Alg. 2
    lines 14-18), else minimum #Edges, first index breaking ties.
    Returns the child result and the dropped position ``j``."""
    single = np.where(amis == 1)[0]
    j = int(single[0]) if single.size else int(np.argmin(edges))
    child_props = tuple(p for i, p in enumerate(current.props) if i != j)
    child = StarSweepResult(props=child_props, ami=int(amis[j]), am=am,
                            n_total_props=n_s, edges=int(edges[j]))
    return child, j


# -- workspaces --------------------------------------------------------------

@runtime_checkable
class SweepWorkspace(Protocol):
    """Per-(class, descent) state: extract once, sweep many.

    ``props`` is the *current* property subset (shrinks as the descent
    drops columns); ``sweep()`` returns ``(edges, amis)`` aligned with it
    (entry ``j`` = subset with ``props[j]`` removed); ``descend(j)``
    commits the drop.  ``sweep_candidates(col_masks)`` evaluates an
    arbitrary ``(C, |S|)`` 0/1 stack of column selections over the FULL
    extracted property list and returns ``(edges, amis)`` aligned with it.
    """

    n_s: int
    am: int

    @property
    def props(self) -> tuple[int, ...]: ...

    def evaluate_current(self) -> StarSweepResult: ...

    def sweep(self) -> tuple[np.ndarray, np.ndarray]: ...

    def sweep_candidates(self, col_masks) -> tuple[np.ndarray, np.ndarray]:
        ...

    def descend(self, j: int) -> None: ...


class _WorkspaceBase:
    """Shared extraction + bookkeeping: one index-join per descent."""

    def __init__(self, store: TripleStore, class_id: int,
                 props: Sequence[int], n_s: int, am: int) -> None:
        self.class_id = int(class_id)
        self.n_s = int(n_s)
        self.am = int(am)
        self._all_props = tuple(int(p) for p in props)
        self.entities, self.matrix = store.object_matrix(
            class_id, self._all_props)
        self._active = list(range(len(self._all_props)))

    @property
    def props(self) -> tuple[int, ...]:
        return tuple(self._all_props[i] for i in self._active)

    @property
    def k(self) -> int:
        return len(self._active)

    def evaluate_current(self) -> StarSweepResult:
        # exact host arithmetic over the already-extracted parent matrix
        a = ami(self.matrix[:, self._active]) if self._active else 0
        return StarSweepResult(
            props=self.props, ami=a, am=self.am, n_total_props=self.n_s,
            edges=num_edges(a, self.am, self.k, self.n_s))

    def descend(self, j: int) -> None:
        # pure bookkeeping: device buffers are untouched (the dropped
        # column is simply masked out of every subsequent sweep)
        del self._active[j]

    def _normalize_masks(self, col_masks) -> np.ndarray:
        masks = np.asarray(col_masks)
        if masks.ndim != 2 or masks.shape[1] != len(self._all_props):
            raise ValueError(
                f"col_masks must be (C, {len(self._all_props)}), "
                f"got {masks.shape}")
        # canonicalize to 0/1: the kernel MULTIPLIES by the mask, so any
        # other truthy value would silently skew ids (and parity)
        return np.ascontiguousarray((masks != 0).astype(np.int32))

    def _drop_one_stack(self, n_rows: int) -> np.ndarray:
        """(n_rows, k_all) 0/1 drop-one stack: row j = active columns
        with column j dropped (a no-op candidate when j is inactive or
        beyond ``k_all`` -- callers discard those rows)."""
        k_all = len(self._all_props)
        base = np.zeros((k_all,), np.int32)
        base[self._active] = 1
        masks = np.repeat(base[None, :], n_rows, axis=0)
        idx = np.arange(min(n_rows, k_all))
        masks[idx, idx] = 0
        return masks


class HostSweepWorkspace(_WorkspaceBase):
    """Sequential numpy evaluation over column views of the parent matrix."""

    def sweep(self) -> tuple[np.ndarray, np.ndarray]:
        # no shape bucket to keep invariant on host: only the active
        # rows of the drop-one stack are evaluated
        masks = self._drop_one_stack(len(self._all_props))
        return self.sweep_candidates(masks[np.asarray(self._active)])

    def sweep_candidates(self, col_masks) -> tuple[np.ndarray, np.ndarray]:
        masks = self._normalize_masks(col_masks)
        EXEC_STATS["descents"] += 1
        n = self.matrix.shape[0]
        amis = np.empty((masks.shape[0],), np.int64)
        for i in range(masks.shape[0]):
            cols = np.flatnonzero(masks[i])
            # zero surviving columns: every row is the same empty tuple
            amis[i] = ami(self.matrix[:, cols]) if cols.size \
                else (1 if n else 0)
        n_sp = (masks != 0).sum(axis=1)
        edges = num_edges_batch(amis, self.am, n_sp, self.n_s)
        return edges, amis


class DeviceSweepWorkspace(_WorkspaceBase):
    """Batched torch sweep over a bucket-padded parent on ``device``.

    The upload happens once, on the first sweep; each candidate batch
    ships only a ``(c_b, k_b)`` mask stack.  Already-descended columns
    stay in the buffer, permanently masked -- dropping a column is a
    host-side bookkeeping update, not a transfer.
    """

    def __init__(self, store, class_id, props, n_s, am, *,
                 device: torch.device | str = "cuda") -> None:
        super().__init__(store, class_id, props, n_s, am)
        self.device = torch.device(device)
        self._dev: torch.Tensor | None = None   # uploaded on first sweep
        self._valid: torch.Tensor | None = None

    def _ensure_uploaded(self) -> None:
        """Bucket-pad and ship the parent matrix ONCE, on first use:
        classes whose descent never sweeps (|SP| <= 2, or a single
        pattern at full S) stay entirely on host."""
        if self._dev is not None:
            return
        n, k = self.matrix.shape
        self.n_bucket = bucket_rows(n)
        self.k_bucket = bucket_cols(k)
        buf = np.zeros((self.n_bucket, self.k_bucket), np.int32)
        buf[:n, :k] = self.matrix
        self._dev = torch.from_numpy(buf).to(self.device)
        self._valid = torch.arange(self.n_bucket, device=self.device) < n

    def sweep(self) -> tuple[np.ndarray, np.ndarray]:
        # the drop-one stack spans FULL bucket height so the sweep shape
        # is invariant across descent levels (one shape per bucket, not
        # per (bucket, |SP|) pair); no-op rows are discarded
        self._ensure_uploaded()
        edges, amis = self.sweep_candidates(
            self._drop_one_stack(self.k_bucket))
        act = np.asarray(self._active)
        return edges[act], amis[act]

    def _run_batch(self, stack: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One launch sequence over a (c_b, k_b) padded stack: the stack
        is the only upload, and (edges, amis) come back in one copy."""
        EXEC_STATS["lowerings"] += 1
        edges, amis = bucket_sweep(
            self._dev, self._valid, torch.from_numpy(stack).to(self.device),
            self.am, self.n_s)
        out = torch.stack([edges, amis]).cpu().numpy()
        return out[0], out[1]

    def sweep_candidates(self, col_masks) -> tuple[np.ndarray, np.ndarray]:
        masks = self._normalize_masks(col_masks)
        EXEC_STATS["descents"] += 1
        self._ensure_uploaded()
        n_cand, k_all = masks.shape
        edges_out = np.empty((n_cand,), np.int64)
        amis_out = np.empty((n_cand,), np.int64)
        for lo in range(0, n_cand, MAX_SWEEP_CANDIDATES):
            chunk = masks[lo:lo + MAX_SWEEP_CANDIDATES]
            c_b = bucket_candidates(chunk.shape[0])
            stack = np.zeros((c_b, self.k_bucket), np.int32)
            stack[:chunk.shape[0], :k_all] = chunk
            edges, amis = self._run_batch(stack)
            m = chunk.shape[0]
            edges_out[lo:lo + m] = edges[:m]
            amis_out[lo:lo + m] = amis[:m]
        return edges_out, amis_out
