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
* **one entity set per candidate, without a (C, N) mask**: under the
  ``folded`` objective (the default; ``star.folded_edges``) a candidate
  SP is scored on E(SP), the entities with exactly one object for every
  property of SP.  The workspace extracts every entity of the class, and
  the device parent holds ``-(row + 1)`` wherever an entity has zero or
  several objects: no real id is negative, so a row with such a cell
  among a candidate's columns is a group of its own, and AMI over E(SP)
  is the kernel's group count less ``N - |E(SP)|``.  |E(SP)| is a
  function of the mask alone, counted on the host from the distinct
  patterns of incomplete columns.  A class whose entities are all
  complete and functional uploads no sentinel and runs the plain route.
  The ``complete`` objective scores Def. 4.8 on the entities complete
  over S, as the JAX package does.
"""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from .. import obs
from .star import StarSweepResult, ami, ami_device_batch, folded_edges, \
    row_groups
from .triples import TripleStore

# what a candidate SP is scored on: ``folded``, the entities SP folds
# (Σ n_p, |E(SP)|), or ``complete``, Def. 4.8 over the entities complete
# over S
OBJECTIVES = ("folded", "complete")


def check_objective(objective: str) -> str:
    """``objective``, or ValueError where it is not one of OBJECTIVES."""
    if objective not in OBJECTIVES:
        raise ValueError(f"objective must be one of {OBJECTIVES}, got "
                         f"{objective!r}")
    return objective

# -- bucket ladder -----------------------------------------------------------

BUCKET_MIN_ROWS = 64    # floor: tiny classes share one bucket shape
BUCKET_MIN_COLS = 2     # star patterns need >= 2 properties
BUCKET_MIN_CANDS = 2    # candidate-axis floor (mirrors the column floor)

# one batch evaluates at most this many candidates; larger stacks are
# chunked so the (c_b, n_b, 2) signature stack stays bounded
MAX_SWEEP_CANDIDATES = 256


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def bucket_rows(n: int, multiple: int = 1) -> int:
    """Row bucket: next power of two >= max(n, floor), rounded up to the
    sharding ``multiple`` (DP degree) so shards stay equal-sized."""
    nb = max(_next_pow2(n), BUCKET_MIN_ROWS)
    if multiple > 1:
        nb += (-nb) % multiple
    return nb


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


# auxiliary per-module counter resets (e.g. core.compress's DECODE_STATS)
# hook in here so one reset_trace_stats() call clears every accounting
# surface
_EXTRA_STAT_RESETS: list = []


def register_stats_reset(fn) -> None:
    """Register an extra zero-the-counters callback invoked by
    :func:`reset_trace_stats` (idempotent per function)."""
    if fn not in _EXTRA_STAT_RESETS:
        _EXTRA_STAT_RESETS.append(fn)


def reset_trace_stats() -> None:
    TRACE_COUNTS.clear()
    EXEC_STATS["lowerings"] = 0
    EXEC_STATS["descents"] = 0
    for fn in _EXTRA_STAT_RESETS:
        fn()


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
                 col_masks: torch.Tensor) -> torch.Tensor:
    """The distinct valid rows of each candidate of a ``(c_b, k_b)`` 0/1
    stack over the ``(n_b, k_b)`` parent, (c_b,) int64 on the parent's
    device."""
    _note_trace("sweep", tuple(parent.shape) + (col_masks.shape[0],))
    return ami_device_batch(parent, valid=valid,
                            col_masks=col_masks).to(torch.int64)


# -- selection rule ----------------------------------------------------------

def pick_child(current: StarSweepResult, edges: np.ndarray,
               amis: np.ndarray, n_s: int, am: int,
               n_e: np.ndarray | None = None
               ) -> tuple[StarSweepResult, int]:
    """Shared selection rule: first AMI == 1 candidate that folds every
    entity (paper Alg. 2 lines 14-18; ``n_e`` the entities each
    candidate scores, all of them where None), else minimum #Edges,
    first index breaking ties.  Returns the child result and the dropped
    position ``j``."""
    ones = amis == 1
    if n_e is not None:
        ones &= np.asarray(n_e) == am
    single = np.flatnonzero(ones)
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
    ``scored_entities(col_masks)`` gives each candidate's |E(SP)| as the
    objective counts it, ``active_mask()`` the current SP and
    ``drop_one_masks()`` the stack ``sweep()`` evaluates.  ``total`` is
    the class's baseline, Σ n_p over S.
    """

    n_s: int
    am: int
    total: int

    @property
    def props(self) -> tuple[int, ...]: ...

    def scored_entities(self, col_masks) -> np.ndarray: ...

    def active_mask(self) -> np.ndarray: ...

    def drop_one_masks(self) -> np.ndarray: ...

    def evaluate_current(self) -> StarSweepResult: ...

    def sweep(self) -> tuple[np.ndarray, np.ndarray]: ...

    def sweep_candidates(self, col_masks) -> tuple[np.ndarray, np.ndarray]:
        ...

    def descend(self, j: int) -> None: ...


class _WorkspaceBase:
    """Shared extraction + bookkeeping: one index-join per descent."""

    def __init__(self, store: TripleStore, class_id: int,
                 props: Sequence[int], n_s: int, am: int,
                 objective: str = "folded") -> None:
        self.class_id = int(class_id)
        self.n_s = int(n_s)
        self.am = int(am)
        self.objective = check_objective(objective)
        self._all_props = tuple(int(p) for p in props)
        ents, mat, one, n_p = store.object_table(class_id, self._all_props)
        if objective == "complete":
            keep = one.all(axis=1)
            ents, mat, one = ents[keep], mat[keep], one[keep]
            self.total = self.am * self.n_s
        else:
            self.total = int(n_p.sum())
        self.entities, self.matrix = ents, mat
        # rows with a column that is not exactly one object, and the
        # distinct patterns of such columns with their row counts: None
        # where every row is complete (the plain route)
        self._one = self._patterns = None
        if not one.all():
            self._one = one
            bad = ~one[~one.all(axis=1)]
            _, counts, rep = row_groups(bad.astype(np.int32))
            self._patterns = (bad[rep].astype(np.int64), counts)
        self._active = list(range(len(self._all_props)))

    @property
    def props(self) -> tuple[int, ...]:
        return tuple(self._all_props[i] for i in self._active)

    @property
    def k(self) -> int:
        return len(self._active)

    def _kept(self, masks: np.ndarray) -> np.ndarray:
        """(C,) rows of the matrix in E(SP) of each 0/1 candidate row."""
        n = self.matrix.shape[0]
        if self._patterns is None:
            return np.full(masks.shape[0], n, np.int64)
        pats, counts = self._patterns
        lost = (pats @ masks.T.astype(np.int64)) > 0       # (P, C)
        return n - counts @ lost

    def _scored(self, kept: np.ndarray) -> np.ndarray:
        """The |E(SP)| the objective scores: the rows kept, or AM where
        Def. 4.8 folds every entity."""
        return kept if self.objective == "folded" \
            else np.full_like(kept, self.am)

    def scored_entities(self, col_masks) -> np.ndarray:
        return self._scored(self._kept(self._normalize_masks(col_masks)))

    def active_mask(self) -> np.ndarray:
        """The (1, |S|) mask of the current SP."""
        mask = np.zeros((1, len(self._all_props)), np.int32)
        mask[0, self._active] = 1
        return mask

    def drop_one_masks(self) -> np.ndarray:
        """The (k, |S|) stack :meth:`sweep` evaluates, row j the active
        columns less the j-th."""
        masks = self._drop_one_stack(len(self._all_props))
        return masks[np.asarray(self._active, np.int64)]

    def _edges(self, amis, kept, n_sp) -> np.ndarray:
        return folded_edges(np.asarray(amis, np.int64), self._scored(kept),
                            np.asarray(n_sp, np.int64), self.total)

    def evaluate_current(self) -> StarSweepResult:
        # exact host arithmetic over the already-extracted parent matrix
        with obs.span("ami.host", rows=int(self.matrix.shape[0])):
            cols = self._active
            mat = self.matrix[:, cols]
            if self._one is not None:
                mat = mat[self._one[:, cols].all(axis=1)]
            a = ami(mat) if cols else 0
        kept = np.array([mat.shape[0]], np.int64)
        return StarSweepResult(
            props=self.props, ami=a, am=self.am, n_total_props=self.n_s,
            edges=int(self._edges(a, kept, self.k)[0]))

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
        return self.sweep_candidates(self.drop_one_masks())

    def sweep_candidates(self, col_masks) -> tuple[np.ndarray, np.ndarray]:
        masks = self._normalize_masks(col_masks)
        EXEC_STATS["descents"] += 1
        n, k = self.matrix.shape
        with obs.span("sweep", candidates=masks.shape[0], n_b=n, k_b=k,
                      rows=n) as sp:
            kept = self._kept(masks)
            amis = np.empty((masks.shape[0],), np.int64)
            for i in range(masks.shape[0]):
                cols = np.flatnonzero(masks[i])
                mat = self.matrix[:, cols]
                if self._one is not None:
                    mat = mat[self._one[:, cols].all(axis=1)]
                # zero surviving columns: every row is the same empty tuple
                amis[i] = ami(mat) if cols.size else (1 if n else 0)
            edges = self._edges(amis, kept, masks.sum(axis=1))
            sp.set(kept=int(kept.sum()))
        return edges, amis


class DeviceSweepWorkspace(_WorkspaceBase):
    """Batched torch sweep over a bucket-padded parent on ``device``.

    The upload happens once, on the first sweep; each candidate batch
    ships only a ``(c_b, k_b)`` mask stack.  Already-descended columns
    stay in the buffer, permanently masked -- dropping a column is a
    host-side bookkeeping update, not a transfer.
    """

    def __init__(self, store, class_id, props, n_s, am,
                 objective: str = "folded", *,
                 device: torch.device | str = "cuda") -> None:
        super().__init__(store, class_id, props, n_s, am, objective)
        self.device = torch.device(device)
        self._dev = None            # uploaded lazily, on the first sweep
        self._valid = None

    def _placement(self, n_rows: int):
        """(row_multiple, place | None): ``place(buf, valid)`` puts the
        padded host parent and its row mask where the sweeps read them;
        ``None`` uploads both whole to ``device``.  Overridden by the
        mesh-sharded workspace."""
        return 1, None

    def _ensure_uploaded(self) -> None:
        """Bucket-pad and ship the parent matrix ONCE, on first use:
        classes whose descent never sweeps (|SP| <= 2, or a single
        pattern at full S) stay entirely on host."""
        if self._dev is not None:
            return
        n, k = self.matrix.shape
        row_multiple, place = self._placement(n)
        self.n_bucket = bucket_rows(n, row_multiple)
        self.k_bucket = bucket_cols(k)
        buf = np.zeros((self.n_bucket, self.k_bucket), np.int32)
        buf[:n, :k] = self.matrix
        if self._one is not None:
            # a cell that is not exactly one object: unique to its row
            sentinel = -1 - np.arange(n, dtype=np.int32)
            np.copyto(buf[:n, :k], sentinel[:, None], where=~self._one)
        if place is not None:
            self._dev, self._valid = place(buf, np.arange(self.n_bucket) < n)
        else:
            self._dev = torch.from_numpy(buf).to(self.device)
            self._valid = torch.arange(self.n_bucket,
                                       device=self.device) < n

    def sweep(self) -> tuple[np.ndarray, np.ndarray]:
        # the drop-one stack spans FULL bucket height so the sweep shape
        # is invariant across descent levels (one shape per bucket, not
        # per (bucket, |SP|) pair); no-op rows are discarded
        edges, amis = self.sweep_candidates(
            self._drop_one_stack(bucket_cols(len(self._all_props))))
        act = np.asarray(self._active)
        return edges[act], amis[act]

    def _run_batch(self, stack: np.ndarray) -> np.ndarray:
        """One launch sequence over a (c_b, k_b) padded stack: the stack
        is the only upload, and the (c_b,) distinct valid rows come back
        in one copy."""
        EXEC_STATS["lowerings"] += 1
        return bucket_sweep(self._dev, self._valid,
                            torch.from_numpy(stack).to(self.device)
                            ).cpu().numpy()

    def sweep_candidates(self, col_masks) -> tuple[np.ndarray, np.ndarray]:
        masks = self._normalize_masks(col_masks)
        EXEC_STATS["descents"] += 1
        n_cand, k_all = masks.shape
        n = self.matrix.shape[0]
        with obs.span("sweep", candidates=n_cand, rows=n) as sp:
            self._ensure_uploaded()
            sp.set(n_b=self.n_bucket, k_b=self.k_bucket)
            amis = np.empty((n_cand,), np.int64)
            for lo in range(0, n_cand, MAX_SWEEP_CANDIDATES):
                chunk = masks[lo:lo + MAX_SWEEP_CANDIDATES]
                c_b = bucket_candidates(chunk.shape[0])
                stack = np.zeros((c_b, self.k_bucket), np.int32)
                stack[:chunk.shape[0], :k_all] = chunk
                amis[lo:lo + chunk.shape[0]] = \
                    self._run_batch(stack)[:chunk.shape[0]]
            # each row outside E(SP) was a group of its own
            kept = self._kept(masks)
            amis -= n - kept
            edges = self._edges(amis, kept, masks.sum(axis=1))
            sp.set(kept=int(kept.sum()))
        return edges, amis


class ShardedSweepWorkspace(DeviceSweepWorkspace):
    """Device workspace with rows sharded over the mesh's DP axes.

    With ``mesh=None`` this *is* the single-device bucketed sweep on
    ``device`` (same bucket ladder, same counters).  On a mesh the parent
    is padded to a multiple of the DP degree and uploaded once, one row
    block per DP coordinate on its device, and the WHOLE candidate stack
    of each chunk runs through one ``ami_bucketed_batch`` exchange -- one
    launch sequence per descent, not one per candidate; the column masks
    apply inside each shard's signature launch.
    """

    def __init__(self, store, class_id, props, n_s, am,
                 objective: str = "folded", *, mesh=None, plan=None,
                 device="cuda") -> None:
        self.mesh = mesh
        self.plan = plan
        self.dp_axes: tuple = ()
        super().__init__(store, class_id, props, n_s, am, objective,
                         device=device)

    def _placement(self, n_rows: int):
        if self.mesh is None:
            return 1, None
        from ..dist.sharding import batch_axes_for
        from .distributed import dp_axes_of, shard_rows
        if self.plan is not None:
            # prefer the planner's rung for this (padded) row count
            axes = tuple(batch_axes_for(self.plan, bucket_rows(n_rows))
                         or self.plan.dp_axes)
        else:
            axes = dp_axes_of(self.mesh)
        self.dp_axes = axes
        row_multiple = int(np.prod(
            [s for a, s in zip(self.mesh.axis_names,
                               self.mesh.devices.shape) if a in axes],
            initial=1))

        def place(buf, valid):
            return (shard_rows(buf, self.mesh, axes),
                    shard_rows(valid, self.mesh, axes))
        return row_multiple, place

    def _run_batch(self, stack: np.ndarray) -> np.ndarray:
        if self.mesh is None:
            return super()._run_batch(stack)
        from .distributed import ami_bucketed_batch
        EXEC_STATS["lowerings"] += 1
        _note_trace("sharded", (self.n_bucket, self.k_bucket,
                                stack.shape[0]))
        return ami_bucketed_batch(self._dev, self._valid, stack, self.mesh,
                                  dp_axes=self.dp_axes
                                  ).cpu().numpy().astype(np.int64)
