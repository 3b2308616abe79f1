"""Batched device star-query evaluation: one launch pair per query stack.

The molecule-match join of ``eval_factorized`` -- "which of the class's
M molecules satisfy this query's ground arms?" -- is the shape the
candidate-batched sweep engine already runs: a (M, K) parent buffer, a
per-candidate column mask, and a row signature.  This module reuses it:

* the molecule table pads to the same power-of-two ``(m_b, k_b)``
  bucket (``core.sweep.bucket_rows`` / ``bucket_cols``) and uploads to
  the device ONCE per (engine, class);
* a stack of Q queries becomes a ``(q_b, k_b)`` 0/1 column-mask stack
  plus an aligned value stack, chunked at ``MAX_SWEEP_CANDIDATES`` and
  padded with all-zero no-op rows (``bucket_candidates`` rung);
* one fused ``kops.row_signature`` launch hashes every masked molecule
  row with the query axis as the candidate axis (padded rows carry the
  sentinel), a second ``(Q, 1, k_b)`` launch hashes the query tuples
  themselves, and the ``(Q, M)`` hit matrix comes back in one copy.

Signatures are 64-bit hashes, so hits are *verified exactly on host*
before members are emitted -- a collision can cost a verification,
never a wrong answer.  First launches of a bucket shape are recorded in
``core.sweep.TRACE_COUNTS`` under the ``"query"`` kind.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.fgraph import FactorizedGraph, MoleculeTable
from ..core.sweep import (MAX_SWEEP_CANDIDATES, _note_trace,
                          bucket_candidates, bucket_cols, bucket_rows)
from ..kernels import ops as kops
from .star import Bindings, StarQuery, eval_factorized, eval_raw


def match_hits(mols: torch.Tensor, valid: torch.Tensor, masks: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """(Q, M) bool: molecule row m's masked signature equals query q's."""
    _note_trace("query", tuple(mols.shape) + (masks.shape[0],))
    sig = kops.row_signature(mols, valid=valid, col_masks=masks)   # (Q, M, 2)
    qsig = kops.row_signature((vals * masks)[:, None, :])          # (Q, 1, 2)
    eq = sig.view(torch.int32) == qsig.view(torch.int32)
    return eq.all(dim=-1) & valid[None, :]


class _TableBuffer:
    """One bucket-padded on-device copy of a class's molecule table."""

    def __init__(self, table: MoleculeTable, device: torch.device) -> None:
        m, k = table.objects.shape
        self.m, self.k = m, k
        self.m_bucket = bucket_rows(m)
        self.k_bucket = bucket_cols(k)
        buf = np.zeros((self.m_bucket, self.k_bucket), np.int32)
        buf[:m, :k] = table.objects
        self.dev = torch.from_numpy(buf).to(device)
        self.valid = torch.arange(self.m_bucket, device=device) < m


def match_molecules_batch(buf: _TableBuffer, table: MoleculeTable,
                          arm_stacks: list[list[tuple[int, int]]]
                          ) -> list[np.ndarray]:
    """Molecule-table rows matching each query's ground SP arms, for a
    whole stack of queries in one launch pair per candidate chunk."""
    device = buf.dev.device
    out: list[np.ndarray] = []
    for lo in range(0, len(arm_stacks), MAX_SWEEP_CANDIDATES):
        chunk = arm_stacks[lo:lo + MAX_SWEEP_CANDIDATES]
        q_b = bucket_candidates(len(chunk))
        masks = np.zeros((q_b, buf.k_bucket), np.int32)
        vals = np.zeros((q_b, buf.k_bucket), np.int32)
        for qi, arms in enumerate(chunk):
            for p, o in arms:
                j = table.col_of(p)
                masks[qi, j] = 1
                vals[qi, j] = o
        hits = match_hits(buf.dev, buf.valid,
                          torch.from_numpy(masks).to(device),
                          torch.from_numpy(vals).to(device)).cpu().numpy()
        for qi, arms in enumerate(chunk):
            rows = np.flatnonzero(hits[qi, :buf.m])
            if rows.size and arms:
                # exact host verification: a signature collision may
                # only ever cost this check, never a wrong binding
                ok = np.ones(rows.shape[0], bool)
                for p, o in arms:
                    ok &= table.objects[rows, table.col_of(p)] == o
                rows = rows[ok]
            out.append(rows)
    return out


class QueryEngine:
    """Star-query engine over one :class:`FactorizedGraph`.

    ``strategy="factorized"`` evaluates on G' directly;
    ``strategy="raw"`` evaluates on the expanded plain graph (built
    lazily, cached).  ``query_batch`` with ``backend="device"`` routes
    every class-constrained query whose ground arms live inside the
    class's SP through the batched molecule match on ``device`` (default
    ``"cuda"``: the hand kernels; a host without CUDA raises there);
    everything else goes through the host path query by query.
    """

    def __init__(self, fgraph: FactorizedGraph, raw_store=None, *,
                 device="cuda") -> None:
        self.fgraph = fgraph
        self._raw = raw_store
        self.device = device
        self._bufs: dict[int, _TableBuffer] = {}   # class -> device table

    @property
    def raw_store(self):
        if self._raw is None:
            self._raw = self.fgraph.expand()
        return self._raw

    def query(self, q: StarQuery, strategy: str = "factorized") -> Bindings:
        if strategy == "factorized":
            return eval_factorized(self.fgraph, q)
        if strategy == "raw":
            return eval_raw(self.raw_store, q)
        raise ValueError(f"unknown query strategy: {strategy!r}")

    def _buffer(self, class_id: int) -> _TableBuffer:
        buf = self._bufs.get(class_id)
        if buf is None:
            buf = _TableBuffer(self.fgraph.tables[class_id],
                               kops.resolve_device(self.device))
            self._bufs[class_id] = buf
        return buf

    def query_batch(self, queries, strategy: str = "factorized",
                    backend: str = "host") -> list[Bindings]:
        queries = list(queries)
        if strategy != "factorized" or backend != "device":
            return [self.query(q, strategy) for q in queries]
        out: list[Bindings | None] = [None] * len(queries)
        # group device-eligible queries per class: the whole group's
        # molecule match runs in one launch pair per chunk
        groups: dict[int, list[int]] = {}
        for i, q in enumerate(queries):
            table = self.fgraph.tables.get(int(q.class_id)) \
                if q.class_id is not None else None
            if table is not None and table.n_molecules and all(
                    table.col_of(p) is not None
                    for p, o in q.ground_arms):
                groups.setdefault(int(q.class_id), []).append(i)
            else:
                out[i] = eval_factorized(self.fgraph, q)
        for cid, idxs in groups.items():
            table = self.fgraph.tables[cid]
            stacks = [queries[i].ground_arms for i in idxs]
            rows = match_molecules_batch(self._buffer(cid), table, stacks)
            for i, r in zip(idxs, rows):
                out[i] = eval_factorized(self.fgraph, queries[i],
                                         _mol_rows=r)
        return out  # type: ignore[return-value]
