"""Online compaction: the long-running service over snapshot swaps.

The paper's factorization is a one-shot batch transform, but Def. 4.8
makes compaction payoff a *live* quantity: inserts and deletes drift
molecule support, and the compact form decays unless frequent star
patterns are re-detected as the graph changes.  This package keeps a
:class:`~repro_torch.api.snapshot.GraphSnapshot` continuously compacted:

* :mod:`~repro_torch.online.wal` -- a write-ahead ingest queue batching triple
  inserts / deletes; a batch stays queued until its successor snapshot
  has swapped in, so a failed apply never loses writes;
* :mod:`~repro_torch.online.drift` -- per-class support-drift tracking (raw-
  residue growth and sub-payoff counters maintained incrementally from
  ``UpdateReport`` / ``DeleteStats`` deltas), deciding WHICH classes are
  worth re-detecting;
* :mod:`~repro_torch.online.metrics` -- accumulator channels (per-batch value
  + running summary) for queue depth, batch/recompaction latency,
  per-class savings, swap count;
* :mod:`~repro_torch.online.service` -- the single-writer loop tying them
  together: drain a batch, swap the successor snapshot atomically,
  re-detect ONLY the drifted classes through the candidate-batched
  sweep engine (wrapped in ``dist.fault`` retry so a failed or
  straggling re-detection never loses the queue).

Readers (a :class:`~repro_torch.query.QueryEngine` rebound to each new
snapshot) hold the service's snapshot handle and never block on any of
this; :mod:`~repro_torch.online.recovery` checkpoints the state and
rebuilds it after a crash.
"""
from .drift import DriftTracker  # noqa: F401
from .metrics import Channel, MetricsHub  # noqa: F401
from .recovery import (RecoveryError, RecoveryReport,  # noqa: F401
                       SnapshotCheckpointer, recover)
from .service import BatchReport, OnlineCompactionService  # noqa: F401
from .wal import DurableWAL, IngestBatch, IngestQueue  # noqa: F401
