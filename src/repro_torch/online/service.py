"""The online compaction service: single writer, snapshot-swap commits.

Loop shape (one :meth:`OnlineCompactionService.step`):

    head = queue.peek()                      # write-ahead: stays queued
    snapshot' = planner.apply_update/delete  # build successor, no mutation
    self._snapshot = snapshot'               # THE swap: one atomic store
    queue.mark_applied(head.seq)             # commit point
    dirty = drift.dirty_classes(...)         # incremental counters
    planner.redetect(snapshot', dirty)       # ONLY drifted classes
                                             # (fault.retry-wrapped)

The swap is a single Python attribute assignment, so readers that
grabbed ``service.snapshot`` before it keep a fully consistent
(immutable) world view -- queries never block on recompaction and never
see torn state.  The write-ahead ordering (apply -> swap -> mark)
means a failure anywhere leaves the head batch queued and the old
snapshot live: nothing is lost, the step just reruns.

**Durability** (optional): give the service a
:class:`~repro_torch.online.wal.DurableWAL` and a
:class:`~repro_torch.online.recovery.SnapshotCheckpointer` (or open it via
:meth:`OnlineCompactionService.durable`) and the write-ahead discipline
extends across process death: every dictionary-tail mint and every
batch is journaled at ``submit`` time, every committed apply run is
journaled with its coalescing, and every ``checkpoint_every`` applied
batches the full snapshot state checkpoints on a background thread
(atomic rename; the journal GCs segments a checkpoint covers).
``repro_torch.online.recovery.recover`` rebuilds the exact pre-crash
state.  Named fault-injection sites (``dist.fault.SITES``) are threaded
through the loop so a seeded :class:`~repro_torch.dist.fault.FaultPlan`
can crash any point of the lifecycle deterministically.

The backend is the planner's: ``backend="device"`` (or a constructed
``DeviceBackend(device=...)``, passed as ``backend=`` or inside
``planner=``) runs every re-detection's sweeps through the hand kernels.
All device work runs on the calling (service) thread; the background
checkpoint thread touches only numpy arrays and the file system.

Re-detection is the expensive part, so it is wrapped in
``dist.fault.retry`` (decorrelated jitter + a ``retry_deadline_s``
budget so a slow pass cannot block the writer unboundedly) with a
``dist.fault.Monitor`` heartbeat: retries land in the
``fault.retries`` channel, dead heartbeats in ``fault.dead_workers``,
and if every attempt fails the dirty classes simply STAY dirty
(counters intact) while ingest continues -- availability over
freshness.

Every step feeds the accumulator metrics channels (``queue.depth``,
``ingest.batch_ms``, ``ingest.unknown_deletes``, ``redetect.ms``,
``redetect.dirty_classes``, ``swap.count``, ``checkpoint.bytes``,
``savings.<class>``, ...): per-batch last value plus running
summaries, exported by :meth:`metrics_summary`.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time

import numpy as np

from ..api.backends import ExecutionBackend
from ..api.snapshot import (CompactionPlanner, DeleteReport, GraphSnapshot,
                            RedetectReport, UpdateReport)
from ..core.fgraph import FactorizedGraph
from ..core.triples import TripleStore
from ..dist import fault

from .drift import DriftTracker
from .metrics import MetricsHub
from .wal import DurableWAL, IngestBatch, IngestQueue


@dataclasses.dataclass
class BatchReport:
    """Everything one ``step`` did: the applied batch, the swap(s), and
    any re-detection it triggered."""

    seq: int
    epoch_before: int
    epoch_after: int
    latency_ms: float
    update: UpdateReport | None = None
    delete: DeleteReport | None = None
    redetect: RedetectReport | None = None


class OnlineCompactionService:
    """Write-ahead ingest + drift-tracked re-detection over snapshots.

    ``source`` may be a plain :class:`TripleStore` (compacted once at
    construction), an existing :class:`GraphSnapshot`, or a bare
    :class:`FactorizedGraph` (wrapped at epoch 0).  All writes go
    through :meth:`submit` (term- or id-level) and apply in FIFO order
    via :meth:`step` / :meth:`drain`; the service is single-writer but
    any number of readers may hold :attr:`snapshot` concurrently.
    """

    def __init__(self, source, *,
                 detector: str = "gfsp",
                 backend: str | ExecutionBackend = "host",
                 planner: CompactionPlanner | None = None,
                 min_predicted_savings: int = 1,
                 drift: DriftTracker | None = None,
                 raw_residue_threshold: int = 8,
                 support_drift_threshold: int = 4,
                 max_backoff: int = 6,
                 metrics: MetricsHub | None = None,
                 monitor: fault.Monitor | None = None,
                 redetect_deadline_s: float = 30.0,
                 retry_attempts: int = 3, retry_base_s: float = 0.01,
                 retry_deadline_s: float | None = 60.0,
                 retry_sleep=None,
                 auto_redetect: bool = True,
                 recompress_threshold: int | None = None,
                 coalesce: bool = True,
                 max_coalesce: int | None = None,
                 wal: DurableWAL | None = None,
                 checkpointer=None,
                 checkpoint_every: int = 8,
                 checkpoint_async: bool = True,
                 fault_plan: fault.FaultPlan | None = None) -> None:
        self.planner = planner or CompactionPlanner(
            detector, backend,
            min_predicted_savings=min_predicted_savings)
        if isinstance(source, GraphSnapshot):
            snap = source
        elif isinstance(source, FactorizedGraph):
            snap = GraphSnapshot(fgraph=source, epoch=0)
        elif isinstance(source, TripleStore):
            snap, _ = self.planner.run(source)
        else:
            raise TypeError(f"cannot serve from {type(source).__name__}")
        self._snapshot = snap
        self.queue = IngestQueue()
        self.drift = drift or DriftTracker(
            raw_residue_threshold=raw_residue_threshold,
            support_drift_threshold=support_drift_threshold,
            max_backoff=max_backoff)
        self.drift.prime(snap.fgraph)
        self.metrics = metrics or MetricsHub()
        # pre-register the soak's gate channels so a clean run exports
        # them with count 0 instead of omitting them
        for ch in ("fault.retries", "fault.dead_workers",
                   "ingest.unknown_deletes", "ingest.recompressions"):
            self.metrics.channel(ch)
        self.monitor = monitor or fault.Monitor(
            deadline_s=redetect_deadline_s,
            on_dead=lambda w: self.metrics.observe(
                "fault.dead_workers", 1),
            on_straggler=lambda w: self.metrics.observe(
                "redetect.stragglers", 1))
        self.retry_attempts = int(retry_attempts)
        self.retry_base_s = float(retry_base_s)
        self.retry_deadline_s = retry_deadline_s
        self._retry_sleep = retry_sleep if retry_sleep is not None \
            else time.sleep
        self._retry_rng = random.Random(0)
        self.auto_redetect = bool(auto_redetect)
        # background recompression of the mutable tail:
        # mutation migrates a compressed-tier store to the plain tier
        # (apply_update decodes once instead of repacking per batch);
        # once ``recompress_threshold`` ingested rows have accumulated
        # on the plain form, the step re-packs it off the hot path
        self.recompress_threshold = (None if recompress_threshold is None
                                     else int(recompress_threshold))
        self._plain_tail = 0
        self.coalesce = bool(coalesce)
        self.max_coalesce = max_coalesce
        self.swap_count = 0
        self._swap_lock = threading.Lock()
        self._redetect_step = 0
        # -- durability ----------------------------------------------------
        self.wal = wal
        self.checkpointer = checkpointer
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_async = bool(checkpoint_async)
        self.fault_plan = fault_plan
        self.last_recovery = None
        self._applied_seq = -1
        self._since_checkpoint = 0
        self._ckpt_thread: threading.Thread | None = None
        self._ckpt_error: BaseException | None = None
        # every dict id below this is journaled (or checkpoint-covered);
        # construction mints (initial compaction) are covered by the
        # initial checkpoint ``durable()`` writes, never by the WAL
        self._minted_upto = len(snap.store.dict) if wal is not None else 0

    @classmethod
    def durable(cls, root: str, source=None, *, wal_kwargs=None,
                keep: int = 3, **kwargs) -> "OnlineCompactionService":
        """Open-or-recover a durable service rooted at ``root``.

        With a valid checkpoint under ``root`` this is
        :func:`repro_torch.online.recovery.recover` (``source`` is ignored;
        ``kwargs`` must match the pre-crash configuration).  Otherwise
        ``source`` seeds a fresh service whose initial compacted state
        is checkpointed immediately -- the armed ``fault_plan`` (if
        any) only goes live after that, so chaos targets the ingest
        lifecycle, not construction.
        """
        from .recovery import (SnapshotCheckpointer, ckpt_dir, has_state,
                               recover, wal_dir)
        if has_state(root):
            return recover(root, wal_kwargs=wal_kwargs, keep=keep,
                           **kwargs)
        if source is None:
            raise FileNotFoundError(
                f"no durable state under {root} and no source given")
        plan = kwargs.pop("fault_plan", None)
        svc = cls(source,
                  wal=DurableWAL(wal_dir(root), **(wal_kwargs or {})),
                  checkpointer=SnapshotCheckpointer(ckpt_dir(root),
                                                    keep=keep),
                  **kwargs)
        svc.checkpoint(wait=True)
        svc.fault_plan = plan
        return svc

    # -- read side ---------------------------------------------------------
    @property
    def snapshot(self) -> GraphSnapshot:
        """The live snapshot.  Reading this is the entire consistency
        protocol: one atomic attribute load of an immutable object."""
        return self._snapshot

    @property
    def fgraph(self) -> FactorizedGraph:
        return self._snapshot.fgraph

    @property
    def applied_seq(self) -> int:
        """Highest committed batch seq (-1 before the first apply)."""
        return self._applied_seq

    def metrics_summary(self) -> dict[str, dict]:
        return self.metrics.summary()

    # -- durability plumbing -----------------------------------------------
    def _fire(self, site: str) -> None:
        if self.fault_plan is not None:
            self.fault_plan.fire(site)

    def _log_mints(self) -> None:
        """Journal every dictionary id minted since the last call, in
        allocation order (submit-time term mints AND apply/redetect-time
        surrogate mints share the one append-only id space)."""
        if self.wal is None:
            return
        d = self._snapshot.store.dict
        n = len(d)
        if n > self._minted_upto:
            self.wal.append_mints(
                [(i, d.term(i)) for i in range(self._minted_upto, n)])
            self._minted_upto = n

    def checkpoint(self, *, wait: bool = False) -> None:
        """Checkpoint the current state (snapshot + dictionary prefix +
        drift counters + applied seq).  Serialization runs on a
        background thread unless ``checkpoint_async=False`` -- every
        array it touches is immutable, so the writer loop keeps going.
        A damaged in-flight write surfaces on the next call (or
        :meth:`close`); the previous checkpoint on disk stays valid."""
        if self.checkpointer is None:
            raise RuntimeError("service has no checkpointer")
        self._join_checkpoint()
        self._log_mints()
        if self.wal is not None:
            self.wal.sync()
        snap = self._snapshot
        args = (snap, self._applied_seq, len(snap.store.dict),
                self.drift.state_dict())
        self._since_checkpoint = 0
        if self.checkpoint_async:
            self._ckpt_thread = threading.Thread(
                target=self._write_checkpoint, args=(*args, False),
                daemon=True)
            self._ckpt_thread.start()
            if wait:
                self._join_checkpoint()
        else:
            self._write_checkpoint(*args, True)

    def _write_checkpoint(self, snap, applied_seq, n_terms, drift_state,
                          reraise) -> None:
        try:
            path = self.checkpointer.write(
                snapshot=snap, applied_seq=applied_seq, n_terms=n_terms,
                drift=drift_state, fire=self._fire)
            from .recovery import _dir_bytes
            self.metrics.observe("checkpoint.bytes", _dir_bytes(path))
            self.metrics.observe("checkpoint.count", 1)
            if self.wal is not None:
                removed = self.wal.gc(applied_seq, n_terms)
                if removed:
                    self.metrics.observe("wal.segments_gcd", removed)
        except BaseException as e:
            self.metrics.observe("checkpoint.failures", 1)
            if reraise:
                raise
            self._ckpt_error = e

    def _join_checkpoint(self) -> None:
        t = self._ckpt_thread
        if t is not None:
            t.join()
            self._ckpt_thread = None
        err, self._ckpt_error = self._ckpt_error, None
        if err is not None:
            raise err

    def close(self) -> None:
        """Flush the journal and wait for any in-flight checkpoint."""
        self._join_checkpoint()
        if self.wal is not None:
            self.wal.close()

    # -- write side --------------------------------------------------------
    def submit(self, inserts=None, delete_triples=None,
               delete_entities=None) -> IngestBatch:
        """Enqueue one edit batch (write-ahead; applied by :meth:`step`).

        Term-level input is id-encoded HERE against the shared
        dictionary: insert terms mint ids (append-only, so encoding
        ahead of apply is safe), delete terms use ``lookup`` -- a term
        the graph has never seen cannot name an existing triple, so
        unknown deletes drop out as no-ops, counted in the
        ``ingest.unknown_deletes`` channel (a growing count means the
        caller's view of the dictionary has skewed).  With a WAL
        attached, the minted tail and the batch are journaled before
        ``submit`` returns; a crash at the ``wal.append`` site means
        the batch was never accepted (the caller re-submits).
        """
        self._fire("wal.append")
        d = self._snapshot.store.dict
        unknown = 0
        term_level_delete = False
        if inserts is not None and not isinstance(inserts, np.ndarray):
            trips = list(inserts)
            inserts = (d.ids([t for spo in trips for t in spo])
                       .reshape(-1, 3) if trips else None)
        if delete_triples is not None and \
                not isinstance(delete_triples, np.ndarray):
            term_level_delete = True
            rows = []
            for s, p, o in delete_triples:
                ids3 = (d.lookup(s), d.lookup(p), d.lookup(o))
                if None not in ids3:
                    rows.append(ids3)
                else:
                    unknown += 1
            delete_triples = np.asarray(rows, np.int32).reshape(-1, 3) \
                if rows else None
        if delete_entities is not None and \
                not isinstance(delete_entities, np.ndarray):
            term_level_delete = True
            ids = [d.lookup(e) for e in delete_entities]
            unknown += sum(1 for i in ids if i is None)
            ids = [i for i in ids if i is not None]
            delete_entities = np.asarray(ids, np.int64) if ids else None
        if term_level_delete:
            self.metrics.observe("ingest.unknown_deletes", unknown)
        batch = self.queue.append(inserts=inserts,
                                  delete_triples=delete_triples,
                                  delete_entities=delete_entities)
        if self.wal is not None:
            self._log_mints()
            self.wal.append_batch(batch)
        self.metrics.observe("queue.depth", self.queue.depth)
        return batch

    def _swap(self, snap: GraphSnapshot) -> None:
        self._snapshot = snap          # the atomic commit
        with self._swap_lock:
            self.swap_count += 1
        self.metrics.observe("swap.count", self.swap_count)

    def step(self) -> BatchReport | None:
        """Apply the head batch -- or, with coalescing on, the maximal
        head run of insert-only batches (plus at most one terminating
        delete-carrying batch) merged into ONE apply: build the
        successor snapshot, swap, commit the run, then re-detect
        drifted classes."""
        if self.coalesce:
            batches = self.queue.peek_coalesced(self.max_coalesce)
        else:
            head = self.queue.peek()
            batches = [head] if head is not None else []
        if not batches:
            return None
        return self._apply_run(batches)

    def apply_exact(self, seqs) -> BatchReport:
        """Apply EXACTLY the head run ``seqs`` as one merged step.

        The recovery path re-applying a journaled ``APPLY`` group: the
        grouping must match the pre-crash coalescing or drift
        accounting (and with it re-detection and mint order) would
        diverge from the uninterrupted run."""
        want = [int(s) for s in seqs]
        head = list(self.queue.peek_coalesced(len(want)))
        got = [b.seq for b in head[:len(want)]]
        if got != want:
            raise ValueError(f"apply_exact({want}) does not match the "
                             f"queue head run {got}")
        return self._apply_run(head[:len(want)])

    def _apply_run(self, batches: list[IngestBatch]) -> BatchReport:
        t0 = time.perf_counter()
        snap = self._snapshot
        epoch_before = snap.epoch
        # Merge the run: inserts concatenate in FIFO order; only the
        # LAST batch of a coalesced run may carry deletes (peek_coalesced
        # guarantees it), and within a batch inserts apply before
        # deletes, so one insert-then-delete apply is order-preserving.
        last = batches[-1]
        inserts = (batches[0].inserts if len(batches) == 1
                   else np.concatenate([b.inserts for b in batches]))
        self._fire("apply")
        upd = dele = None
        if inserts.shape[0]:
            snap, upd = self.planner.apply_update(snap, inserts)
        if last.delete_triples.shape[0] or last.delete_entities.shape[0]:
            snap, dele = self.planner.apply_delete(
                snap,
                triples=(last.delete_triples
                         if last.delete_triples.shape[0] else None),
                entities=(last.delete_entities
                          if last.delete_entities.shape[0] else None))
        self._log_mints()                  # surrogate mints, pre-swap
        self._fire("pre_swap")
        if snap is not self._snapshot:
            self._swap(snap)
        self._fire("post_swap")
        if self.wal is not None:
            self.wal.append_applied([b.seq for b in batches])
        # commit point: swap landed; drop the whole run in order
        self.queue.mark_applied_through([b.seq for b in batches])
        self._applied_seq = last.seq
        self.metrics.observe("ingest.coalesced_batches", len(batches))
        if upd is not None:
            self.drift.observe_update(upd)
        if dele is not None:
            self.drift.observe_delete(dele.stats)
        latency = (time.perf_counter() - t0) * 1e3
        self.metrics.observe("ingest.batch_ms", latency)
        self.metrics.observe("queue.depth", self.queue.depth)
        red = None
        if self.auto_redetect:
            dirty = self.drift.dirty_classes(self._snapshot.fgraph)
            if dirty:
                red = self.redetect(dirty)
        self._plain_tail += int(inserts.shape[0])
        self._maybe_recompress()
        # checkpoint LAST: a checkpoint between commit and this step's
        # re-detection would restore to a state whose redetect never
        # re-runs (the batch is already inside the checkpoint), silently
        # diverging from the uninterrupted run's mint order
        if self.checkpointer is not None:
            self._since_checkpoint += len(batches)
            if self._since_checkpoint >= self.checkpoint_every:
                self.checkpoint()
        return BatchReport(seq=last.seq, epoch_before=epoch_before,
                           epoch_after=self._snapshot.epoch,
                           latency_ms=latency, update=upd, delete=dele,
                           redetect=red)

    def _maybe_recompress(self) -> None:
        """Re-pack the plain mutable tail once it outgrows the
        threshold: build the compressed store off the hot path (the
        writer is between batches; readers keep the old snapshot) and
        swap it under the unchanged molecule tables.  ``compact_dict=
        False`` is mandatory -- the WAL journals dictionary mints by id,
        so the shared dict *object* must survive the repack."""
        if self.recompress_threshold is None \
                or self._plain_tail < self.recompress_threshold:
            return
        snap = self._snapshot
        store = snap.fgraph.store
        if getattr(store, "is_compressed", False):
            self._plain_tail = 0
            return
        t0 = time.perf_counter()
        packed = store.compressed(compact_dict=False)
        self._swap(snap.next(snap.fgraph.with_store(packed)))
        self._plain_tail = 0
        self.metrics.observe("ingest.recompressions", 1)
        self.metrics.observe("ingest.recompress_ms",
                             (time.perf_counter() - t0) * 1e3)

    def drain(self, max_batches: int | None = None) -> list[BatchReport]:
        """Apply queued batches FIFO until empty (or ``max_batches``)."""
        out: list[BatchReport] = []
        while self.queue and (max_batches is None
                              or len(out) < max_batches):
            rep = self.step()
            if rep is None:     # pragma: no cover - queue raced empty
                break
            out.append(rep)
        return out

    # -- re-detection ------------------------------------------------------
    def redetect(self, class_ids) -> RedetectReport | None:
        """Re-detect ONLY ``class_ids``, retried on failure.

        The pass runs against the current snapshot under
        ``dist.fault.retry`` (decorrelated jitter, overall
        ``retry_deadline_s`` budget) with Monitor heartbeats; on success
        the successor swaps in and the drift baselines reset.  If every
        attempt fails the old snapshot stays live, the ingest queue is
        untouched, and the classes remain dirty -- the next batch will
        trigger another try.
        """
        cids = [int(c) for c in class_ids]
        if not cids:
            return None

        def attempt():
            self._fire("redetect")
            self._redetect_step += 1
            self.monitor.record("redetect", self._redetect_step)
            out = self.planner.redetect(self._snapshot, cids)
            self.monitor.record("redetect", self._redetect_step)
            self.monitor.check()
            return out

        try:
            snap, report = fault.retry(
                attempt, attempts=self.retry_attempts,
                base_s=self.retry_base_s, sleep=self._retry_sleep,
                deadline_s=self.retry_deadline_s, rng=self._retry_rng,
                on_retry=lambda a, d, e: self.metrics.observe(
                    "fault.retries", 1))()
        except fault.InjectedFault:
            raise               # injection models process death
        except Exception:
            # exhausted: stay on the old snapshot, keep the drift
            # counters -- re-detection is an optimization, never a
            # correctness requirement
            self.metrics.observe("redetect.failures", 1)
            return None
        if snap is not self._snapshot:     # rejected passes don't swap
            self._log_mints()
            self._swap(snap)
        # re-baseline either way: the decision was made against this
        # state; drift re-accumulates before the classes go dirty again
        # -- but a rejected pass also bumps the classes' backoff, so
        # repeat offenders need exponentially more drift to re-trigger
        self.drift.note_redetected(snap.fgraph, report.considered,
                                   rejected=report.rejected)
        self.metrics.observe("redetect.ms", report.exec_time_ms)
        self.metrics.observe("redetect.dirty_classes", len(cids))
        self.metrics.observe("redetect.descents", report.descents)
        term = snap.store.dict.term
        for cid, saving in report.per_class_savings.items():
            self.metrics.observe(f"savings.{term(cid)}", saving)
        return report
