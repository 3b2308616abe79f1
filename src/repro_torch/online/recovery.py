"""Durable snapshot checkpoints + crash recovery for the online service.

A durable service root looks like::

    <root>/wal/seg_00000000.wal ...     append-only journal (online.wal)
    <root>/ckpt/step_00000012/          one checkpoint per applied batch
        manifest.json                   counts, meta, drift, file sha1s
        terms.bin / terms_len.npy       dictionary prefix, allocation order
        spo.npy                         packed triple ids
        table_<cid>_{surrogates,objects}.npy

Checkpoints are published atomically: stage into ``step_<n>.tmp``,
write the manifest LAST, then one ``os.replace`` publishes the whole
directory.  A reader never sees a half-written checkpoint, and
validation (manifest parses + every file present with a matching sha1)
falls back to the previous step if the newest one is damaged.  ``step`` is ``applied_seq + 1`` so a fresh
service (nothing applied, ``applied_seq == -1``) checkpoints as step 0.

:func:`recover` rebuilds a live :class:`OnlineCompactionService`:
restore the latest valid checkpoint, replay the WAL -- every ``MINT``
in allocation order first (asserting exact id reproduction against the
checkpoint prefix), queue every ``BATCH`` past the checkpoint's
``applied_seq`` -- then re-apply logged ``APPLY`` groups under the
exact pre-crash coalescing.  Surrogate names are deterministic
(``repro:sg/<class>/<ordinal>``) and ``TermDict.ids`` is get-or-mint,
so re-applying a batch whose mints were already journaled reproduces
identical ids; the recovered run's digest matches an uninterrupted run
over the same submissions.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time

import numpy as np

from ..api.snapshot import GraphSnapshot
from ..core.triples import TermDict

from .wal import DurableWAL, IngestBatch


class RecoveryError(RuntimeError):
    """The journal contradicts the checkpoint (ids fail to reproduce)."""


def _sha1(path: str) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


@dataclasses.dataclass
class RestoredCheckpoint:
    """One valid checkpoint, fully loaded."""

    step: int
    path: str
    applied_seq: int
    n_terms: int
    snapshot: GraphSnapshot
    drift: dict
    nbytes: int


@dataclasses.dataclass
class RecoveryReport:
    """What one :func:`recover` call did (also exported to metrics)."""

    checkpoint_step: int
    checkpoint_bytes: int
    applied_seq: int
    n_terms_checkpoint: int
    mints_replayed: int
    batches_pending: int
    batches_skipped: int       # journaled but already inside the checkpoint
    apply_runs_replayed: int
    truncated_bytes: int
    dropped_segments: int
    replay_ms: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class SnapshotCheckpointer:
    """Atomic-rename checkpoint store for ``GraphSnapshot`` + service
    state (dictionary prefix, drift counters, applied seq)."""

    def __init__(self, root: str, *, keep: int = 3) -> None:
        self.root = root
        self.keep = int(keep)
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def steps(self) -> list[int]:
        out = []
        for n in os.listdir(self.root):
            if n.startswith("step_") and not n.endswith(".tmp"):
                try:
                    out.append(int(n[5:13]))
                except ValueError:
                    continue
        return sorted(out)

    # -- write -------------------------------------------------------------
    def write(self, *, snapshot: GraphSnapshot, applied_seq: int,
              n_terms: int, drift: dict, fire=None) -> str:
        """Serialize one checkpoint; returns the published directory.

        ``fire`` is the fault-injection hook (site ``checkpoint.write``
        trips after staging, before the atomic publish -- a crash there
        leaves only ``.tmp`` garbage and the previous checkpoint
        intact)."""
        step = int(applied_seq) + 1
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays, meta = snapshot.to_state()
        d = snapshot.store.dict
        terms = [d.term(i) for i in range(int(n_terms))]
        raw = [t.encode("utf-8") for t in terms]
        files: dict[str, str] = {}
        with open(os.path.join(tmp, "terms.bin"), "wb") as f:
            f.write(b"".join(raw))
            f.flush()
            os.fsync(f.fileno())
        np.save(os.path.join(tmp, "terms_len.npy"),
                np.asarray([len(r) for r in raw], np.int64))
        for key, arr in arrays.items():
            np.save(os.path.join(tmp, f"{key}.npy"),
                    np.ascontiguousarray(arr))
        for name in sorted(os.listdir(tmp)):
            files[name] = _sha1(os.path.join(tmp, name))
        manifest = {"applied_seq": int(applied_seq),
                    "n_terms": int(n_terms),
                    "meta": meta, "drift": drift, "files": files,
                    "created_unix": time.time()}
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if fire is not None:
            fire("checkpoint.write")
        if os.path.exists(final):          # idempotent re-checkpoint
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        for n in os.listdir(self.root):
            if n.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, n),
                              ignore_errors=True)

    # -- read --------------------------------------------------------------
    def validate(self, step: int) -> dict | None:
        """Manifest of ``step`` if the checkpoint is complete and every
        file hash matches; ``None`` for damaged/partial checkpoints."""
        path = self._step_dir(step)
        mpath = os.path.join(path, "manifest.json")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            for name, digest in manifest["files"].items():
                if _sha1(os.path.join(path, name)) != digest:
                    return None
        except (OSError, ValueError, KeyError):
            return None
        return manifest

    def latest_valid(self) -> int | None:
        for step in reversed(self.steps()):
            if self.validate(step) is not None:
                return step
        return None

    def restore(self, step: int) -> RestoredCheckpoint:
        manifest = self.validate(step)
        if manifest is None:
            raise RecoveryError(f"checkpoint step {step} is damaged")
        path = self._step_dir(step)
        lens = np.load(os.path.join(path, "terms_len.npy"))
        with open(os.path.join(path, "terms.bin"), "rb") as f:
            blob = f.read()
        offs = np.concatenate([[0], np.cumsum(lens)])
        terms = [blob[offs[i]:offs[i + 1]].decode("utf-8")
                 for i in range(len(lens))]
        dictionary = TermDict.from_terms(terms)
        arrays = {}
        for name in manifest["files"]:
            if name.endswith(".npy") and name != "terms_len.npy":
                arrays[name[:-4]] = np.load(os.path.join(path, name))
        snapshot = GraphSnapshot.from_state(dictionary, arrays,
                                            manifest["meta"])
        return RestoredCheckpoint(
            step=step, path=path,
            applied_seq=int(manifest["applied_seq"]),
            n_terms=int(manifest["n_terms"]), snapshot=snapshot,
            drift=manifest["drift"], nbytes=_dir_bytes(path))

    def restore_latest(self) -> RestoredCheckpoint | None:
        step = self.latest_valid()
        return None if step is None else self.restore(step)


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------

def wal_dir(root: str) -> str:
    return os.path.join(root, "wal")


def ckpt_dir(root: str) -> str:
    return os.path.join(root, "ckpt")


def has_state(root: str) -> bool:
    """True if ``root`` holds at least one valid checkpoint."""
    if not os.path.isdir(ckpt_dir(root)):
        return False
    return SnapshotCheckpointer(ckpt_dir(root)).latest_valid() is not None


def recover(root: str, *, wal_kwargs: dict | None = None,
            keep: int = 3, **service_kwargs):
    """Rebuild a live service from ``root`` after a crash.

    Restores the latest valid checkpoint, replays the journal (mints
    with exact-id assertions, then the pending batch suffix), re-applies
    journaled ``APPLY`` groups under the original coalescing, and
    returns the service with ``last_recovery`` set.  ``service_kwargs``
    must match the pre-crash configuration (detector, backend,
    thresholds) -- they are not persisted.
    """
    from .service import OnlineCompactionService

    t0 = time.perf_counter()
    ck = SnapshotCheckpointer(ckpt_dir(root), keep=keep)
    restored = ck.restore_latest()
    if restored is None:
        raise FileNotFoundError(f"no valid checkpoint under {root}")
    d = restored.snapshot.store.dict
    wal = DurableWAL(wal_dir(root), **(wal_kwargs or {}))
    mints_replayed = 0
    skipped = 0
    pending: list[IngestBatch] = []
    apply_runs: list[list[int]] = []
    max_seq = restored.applied_seq
    for kind, rec in wal.replay():
        if kind == "mint":
            for tid, term in rec:
                if tid < len(d):
                    if d.term(tid) != term:
                        raise RecoveryError(
                            f"mint replay diverged at id {tid}: journal "
                            f"{term!r} vs checkpoint {d.term(tid)!r}")
                    continue
                got = d.id(term)
                if got != tid:
                    raise RecoveryError(
                        f"mint replay out of order: {term!r} journaled "
                        f"as {tid}, re-minted as {got}")
                mints_replayed += 1
        elif kind == "batch":
            max_seq = max(max_seq, rec.seq)
            if rec.seq > restored.applied_seq:
                pending.append(rec)
            else:
                skipped += 1
        else:                                   # "apply"
            runs = [s for s in rec if s > restored.applied_seq]
            if runs:
                apply_runs.append(runs)
    svc = OnlineCompactionService(
        restored.snapshot, wal=wal, checkpointer=ck, **service_kwargs)
    svc.drift.load_state(restored.drift)
    svc.queue.restore(pending, next_seq=max_seq + 1)
    svc._applied_seq = restored.applied_seq
    # re-apply the suffix the pre-crash process had already committed,
    # group by group; whatever remains queued was never applied anywhere
    # and drains under normal coalescing
    runs_replayed = 0
    applied = restored.applied_seq
    for run in apply_runs:
        run = [s for s in run if s > applied]
        if not run:
            continue                # duplicate from a prior recovery
        svc.apply_exact(run)
        applied = run[-1]
        runs_replayed += 1
    report = RecoveryReport(
        checkpoint_step=restored.step,
        checkpoint_bytes=restored.nbytes,
        applied_seq=restored.applied_seq,
        n_terms_checkpoint=restored.n_terms,
        mints_replayed=mints_replayed,
        batches_pending=len(pending), batches_skipped=skipped,
        apply_runs_replayed=runs_replayed,
        truncated_bytes=wal.truncated_bytes,
        dropped_segments=wal.dropped_segments,
        replay_ms=(time.perf_counter() - t0) * 1e3)
    svc.last_recovery = report
    svc.metrics.observe("recovery.checkpoint_bytes",
                        report.checkpoint_bytes)
    svc.metrics.observe("recovery.replay_ms", report.replay_ms)
    svc.metrics.observe("recovery.batches_replayed",
                        report.batches_pending)
    svc.metrics.observe("recovery.mints_replayed", report.mints_replayed)
    return svc
