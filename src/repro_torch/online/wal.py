"""Write-ahead ingest: in-memory queue + append-only on-disk journal.

Edits enter as id-encoded batches (the service encodes terms at submit
time, so a queued batch is replayable against any snapshot sharing the
dictionary).  The head batch stays in the queue until the service has
built AND swapped the successor snapshot -- ``mark_applied`` is the
commit point -- so a crash or a failed apply between ``peek`` and the
swap never loses writes: the next ``step`` sees the same head again.
Apply order is strictly FIFO (``mark_applied`` refuses anything but the
head), which is what makes replays deterministic.

:class:`DurableWAL` extends the write-ahead discipline across process
death.  Segments (``seg_<n>.wal``) hold CRC32-framed records::

    magic  b"FSPWAL01"                                  (per segment)
    record [type u8][payload_len u32][crc32 u32][payload]

Three record types share one sequential log: ``MINT`` (dictionary-tail
term mints, in allocation order -- ids are minted at ``submit()`` and
at apply/redetect time, and recovery must replay every mint before any
batch so replayed ids match exactly), ``BATCH`` (one
:class:`IngestBatch`: seq + the three id arrays) and ``APPLY`` (the
seq group one committed step applied, so recovery re-applies the
suffix under the exact pre-crash coalescing).  Because the log is
sequential and recovery truncates at the FIRST invalid frame (torn
tail), any crash leaves a consistent prefix of the allocation order --
later fsyncs persist earlier appends for free.  Segment GC drops
segments wholly covered by a checkpoint: every batch seq applied and
every mint id below the checkpointed dictionary length.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import zlib
from collections import deque
from typing import Iterable, Iterator

import numpy as np

_EMPTY3 = np.empty((0, 3), np.int32)
_EMPTY1 = np.empty((0,), np.int64)


@dataclasses.dataclass(frozen=True)
class IngestBatch:
    """One queued edit batch, id-encoded over the shared dictionary."""

    seq: int
    inserts: np.ndarray         # (n, 3) int32 triple ids
    delete_triples: np.ndarray  # (m, 3) int32 triple ids
    delete_entities: np.ndarray  # (k,) int64 entity ids

    @property
    def n_edits(self) -> int:
        return int(self.inserts.shape[0] + self.delete_triples.shape[0]
                   + self.delete_entities.shape[0])

    @property
    def empty(self) -> bool:
        return self.n_edits == 0


class IngestQueue:
    """FIFO write-ahead queue of :class:`IngestBatch` entries."""

    def __init__(self) -> None:
        self._batches: deque[IngestBatch] = deque()
        self._next_seq = 0
        self.n_applied = 0

    def append(self, inserts=None, delete_triples=None,
               delete_entities=None) -> IngestBatch:
        batch = IngestBatch(
            seq=self._next_seq,
            inserts=(np.asarray(inserts, np.int32).reshape(-1, 3)
                     if inserts is not None else _EMPTY3),
            delete_triples=(np.asarray(delete_triples,
                                       np.int32).reshape(-1, 3)
                            if delete_triples is not None else _EMPTY3),
            delete_entities=(np.asarray(delete_entities,
                                        np.int64).reshape(-1)
                             if delete_entities is not None else _EMPTY1))
        self._next_seq += 1
        self._batches.append(batch)
        return batch

    def restore(self, batches: Iterable[IngestBatch], *,
                next_seq: int | None = None, n_applied: int = 0) -> None:
        """Reload the pending suffix after recovery.

        ``batches`` must be ascending by seq; ``next_seq`` must exceed
        every seq the journal has ever handed out (replayed OR already
        applied) so a post-recovery ``append`` never collides with a
        surviving WAL record.
        """
        if self._batches or self._next_seq:
            raise ValueError("restore() requires a fresh queue")
        last = -1
        for b in batches:
            if b.seq <= last:
                raise ValueError(f"restore out of order: {b.seq} "
                                 f"after {last}")
            last = b.seq
            self._batches.append(b)
        self._next_seq = (next_seq if next_seq is not None else last + 1)
        if self._next_seq <= last:
            raise ValueError(f"next_seq {self._next_seq} collides with "
                             f"restored seq {last}")
        self.n_applied = int(n_applied)

    def peek(self) -> IngestBatch | None:
        """The head batch, NOT removed -- it leaves only via
        :meth:`mark_applied` after its snapshot swapped in."""
        return self._batches[0] if self._batches else None

    def peek_coalesced(self, max_batches: int | None = None
                       ) -> list[IngestBatch]:
        """Maximal coalescible head run, NOT removed.

        Adjacent insert-only batches merge into one apply; a batch
        carrying deletes may terminate the run (inside a batch inserts
        apply before deletes, so ``inserts(0..i) then deletes(i)``
        preserves the FIFO-apply semantics) but can never be followed.
        Commit the run with :meth:`mark_applied_through` -- the batches
        stay write-ahead until then, and a failed merged apply reruns
        the identical run.
        """
        run: list[IngestBatch] = []
        for b in self._batches:
            run.append(b)
            if b.delete_triples.shape[0] or b.delete_entities.shape[0]:
                break
            if max_batches is not None and len(run) >= max_batches:
                break
        return run

    def mark_applied_through(self, seqs) -> None:
        """Commit a contiguous head run, in order (each drop goes
        through :meth:`mark_applied`, so the strict-head discipline --
        and its out-of-order error -- is unchanged)."""
        for s in seqs:
            self.mark_applied(int(s))

    def mark_applied(self, seq: int) -> None:
        """Commit point: drop the head batch (and only the head)."""
        if not self._batches or self._batches[0].seq != seq:
            head = self._batches[0].seq if self._batches else None
            raise ValueError(f"mark_applied({seq}) out of order "
                             f"(head is {head})")
        self._batches.popleft()
        self.n_applied += 1

    @property
    def depth(self) -> int:
        return len(self._batches)

    def __len__(self) -> int:
        return len(self._batches)

    def __bool__(self) -> bool:
        return bool(self._batches)


# -- on-disk journal ---------------------------------------------------------

WAL_MAGIC = b"FSPWAL01"
REC_MINT = 1
REC_BATCH = 2
REC_APPLY = 3
_HEADER = struct.Struct("<BII")          # type, payload_len, crc32


def _frame(rec_type: int, payload: bytes) -> bytes:
    return _HEADER.pack(rec_type, len(payload),
                        zlib.crc32(payload) & 0xFFFFFFFF) + payload


def _encode_mints(mints: list[tuple[int, str]]) -> bytes:
    parts = [struct.pack("<I", len(mints))]
    for tid, term in mints:
        raw = term.encode("utf-8")
        parts.append(struct.pack("<II", int(tid), len(raw)))
        parts.append(raw)
    return b"".join(parts)


def _decode_mints(payload: bytes) -> list[tuple[int, str]]:
    (n,) = struct.unpack_from("<I", payload, 0)
    pos, out = 4, []
    for _ in range(n):
        tid, ln = struct.unpack_from("<II", payload, pos)
        pos += 8
        out.append((tid, payload[pos:pos + ln].decode("utf-8")))
        pos += ln
    if pos != len(payload):
        raise ValueError("mint payload length mismatch")
    return out


def _encode_apply(seqs: list[int]) -> bytes:
    return struct.pack("<I", len(seqs)) \
        + struct.pack(f"<{len(seqs)}q", *[int(s) for s in seqs])


def _decode_apply(payload: bytes) -> list[int]:
    (n,) = struct.unpack_from("<I", payload, 0)
    if len(payload) != 4 + 8 * n:
        raise ValueError("apply payload length mismatch")
    return list(struct.unpack_from(f"<{n}q", payload, 4))


def _encode_batch(batch: IngestBatch) -> bytes:
    ins = np.ascontiguousarray(batch.inserts, np.int32)
    delt = np.ascontiguousarray(batch.delete_triples, np.int32)
    dele = np.ascontiguousarray(batch.delete_entities, np.int64)
    return (struct.pack("<qIII", int(batch.seq), ins.shape[0],
                        delt.shape[0], dele.shape[0])
            + ins.tobytes() + delt.tobytes() + dele.tobytes())


def _decode_batch(payload: bytes) -> IngestBatch:
    seq, n_ins, n_delt, n_dele = struct.unpack_from("<qIII", payload, 0)
    pos = 20
    expect = pos + n_ins * 12 + n_delt * 12 + n_dele * 8
    if expect != len(payload):
        raise ValueError("batch payload length mismatch")
    ins = np.frombuffer(payload, np.int32, n_ins * 3, pos).reshape(-1, 3)
    pos += n_ins * 12
    delt = np.frombuffer(payload, np.int32, n_delt * 3, pos).reshape(-1, 3)
    pos += n_delt * 12
    dele = np.frombuffer(payload, np.int64, n_dele, pos)
    return IngestBatch(seq=int(seq), inserts=ins, delete_triples=delt,
                       delete_entities=dele)


@dataclasses.dataclass
class _SegmentStats:
    """Per-segment GC bookkeeping (maintained on scan AND append)."""

    max_seq: int = -1
    max_mint_id: int = -1

    def note(self, rec_type: int, payload: bytes) -> None:
        if rec_type == REC_BATCH:
            (seq,) = struct.unpack_from("<q", payload, 0)
            self.max_seq = max(self.max_seq, int(seq))
        elif rec_type == REC_APPLY:
            seqs = _decode_apply(payload)
            if seqs:
                self.max_seq = max(self.max_seq, max(seqs))
        else:
            for tid, _ in _decode_mints(payload):
                self.max_mint_id = max(self.max_mint_id, int(tid))


def _scan_segment(path: str) -> tuple[int, int, _SegmentStats]:
    """Validate one segment; return (valid_end, file_size, stats).

    ``valid_end`` is the byte offset of the longest valid record
    prefix; anything past it is a torn tail (or corruption) to be
    truncated.  A bad magic invalidates the whole file
    (``valid_end == 0``).
    """
    with open(path, "rb") as f:
        data = f.read()
    stats = _SegmentStats()
    if not data.startswith(WAL_MAGIC):
        return 0, len(data), stats
    pos = len(WAL_MAGIC)
    while pos < len(data):
        if pos + _HEADER.size > len(data):
            break
        rec_type, ln, crc = _HEADER.unpack_from(data, pos)
        end = pos + _HEADER.size + ln
        if rec_type not in (REC_MINT, REC_BATCH, REC_APPLY) \
                or end > len(data):
            break
        payload = data[pos + _HEADER.size:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break
        try:
            stats.note(rec_type, payload)
        except Exception:
            break               # framed fine but payload malformed
        pos = end
    return pos, len(data), stats


class DurableWAL:
    """Append-only segmented journal for mints and ingest batches.

    Opening the journal validates every segment in order and truncates
    at the first invalid frame -- the recovered log is always the
    longest valid prefix of what was written (``truncated_bytes`` /
    ``dropped_segments`` report what was cut).  ``fsync_policy``:

    * ``"every_batch"`` -- fsync after each :meth:`append_batch` (mint
      records ride the next batch's fsync; the log is sequential, so a
      later fsync persists every earlier append);
    * ``"interval"`` -- flush always, fsync at most once per
      ``fsync_interval_s``.

    The appender is single-threaded (the service's writer loop) but
    :meth:`gc` may run from the checkpoint writer thread, hence the
    lock around segment bookkeeping.
    """

    def __init__(self, root: str, *, fsync_policy: str = "every_batch",
                 fsync_interval_s: float = 1.0,
                 segment_max_bytes: int = 4 << 20,
                 clock=time.monotonic) -> None:
        if fsync_policy not in ("every_batch", "interval"):
            raise ValueError(f"unknown fsync policy {fsync_policy!r}")
        self.root = root
        self.fsync_policy = fsync_policy
        self.fsync_interval_s = float(fsync_interval_s)
        self.segment_max_bytes = int(segment_max_bytes)
        self._clock = clock
        self._last_sync = clock()
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)
        self.truncated_bytes = 0
        self.dropped_segments = 0
        self._segments: list[str] = []           # full paths, in order
        self._stats: dict[str, _SegmentStats] = {}
        self._open_scan()
        self._fh = open(self._segments[-1], "ab")
        if self._fh.tell() == 0:
            self._fh.write(WAL_MAGIC)
            self._fh.flush()

    # -- open / scan -------------------------------------------------------
    def _seg_path(self, n: int) -> str:
        return os.path.join(self.root, f"seg_{n:08d}.wal")

    def _open_scan(self) -> None:
        names = sorted(n for n in os.listdir(self.root)
                       if n.startswith("seg_") and n.endswith(".wal"))
        paths = [os.path.join(self.root, n) for n in names]
        for i, path in enumerate(paths):
            valid_end, size, stats = _scan_segment(path)
            self._segments.append(path)
            self._stats[path] = stats
            if valid_end < size:
                self.truncated_bytes += size - valid_end
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
                # everything after the corruption was written later:
                # keeping it would break the prefix property
                for later in paths[i + 1:]:
                    with open(later, "rb") as f:
                        self.truncated_bytes += len(f.read())
                    os.remove(later)
                    self.dropped_segments += 1
                break
        if not self._segments:
            self._segments.append(self._seg_path(0))
            self._stats[self._segments[0]] = _SegmentStats()

    # -- append ------------------------------------------------------------
    def _maybe_rotate(self) -> None:
        if self._fh.tell() < self.segment_max_bytes:
            return
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        last = os.path.basename(self._segments[-1])
        n = int(last[4:12]) + 1
        with self._lock:
            path = self._seg_path(n)
            self._segments.append(path)
            self._stats[path] = _SegmentStats()
        self._fh = open(path, "ab")
        self._fh.write(WAL_MAGIC)

    def _append(self, rec_type: int, payload: bytes) -> None:
        self._maybe_rotate()
        self._fh.write(_frame(rec_type, payload))
        with self._lock:
            self._stats[self._segments[-1]].note(rec_type, payload)

    def append_mints(self, mints: list[tuple[int, str]]) -> None:
        """Journal dictionary-tail mints, in allocation order.  Must be
        called BEFORE the batch (or checkpoint) that references the
        ids -- recovery replays the log sequentially."""
        if not mints:
            return
        self._append(REC_MINT, _encode_mints(mints))
        self._fh.flush()

    def append_batch(self, batch: IngestBatch) -> None:
        self._append(REC_BATCH, _encode_batch(batch))
        self._fh.flush()
        if self.fsync_policy == "every_batch":
            os.fsync(self._fh.fileno())
            self._last_sync = self._clock()
        elif self._clock() - self._last_sync >= self.fsync_interval_s:
            os.fsync(self._fh.fileno())
            self._last_sync = self._clock()

    def append_applied(self, seqs: list[int]) -> None:
        """Journal one committed apply run (the coalesced seq group).
        Recovery re-applies logged groups EXACTLY as the pre-crash
        process grouped them -- coalescing changes drift accounting and
        with it re-detection decisions and mint order, so replaying a
        suffix under a different grouping would diverge from the
        uninterrupted run's id assignment."""
        self._append(REC_APPLY, _encode_apply(list(seqs)))
        self._fh.flush()

    def sync(self) -> None:
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._last_sync = self._clock()

    # -- replay ------------------------------------------------------------
    def replay(self) -> Iterator[tuple[str, object]]:
        """Yield ``("mint", [(id, term), ...])`` and ``("batch",
        IngestBatch)`` in write order.  Only call on a freshly opened
        journal (open-time scan already truncated any torn tail)."""
        self._fh.flush()
        with self._lock:
            segments = list(self._segments)
        for path in segments:
            with open(path, "rb") as f:
                data = f.read()
            pos = len(WAL_MAGIC)
            while pos + _HEADER.size <= len(data):
                rec_type, ln, _ = _HEADER.unpack_from(data, pos)
                payload = data[pos + _HEADER.size:pos + _HEADER.size + ln]
                pos += _HEADER.size + ln
                if rec_type == REC_MINT:
                    yield "mint", _decode_mints(payload)
                elif rec_type == REC_APPLY:
                    yield "apply", _decode_apply(payload)
                else:
                    yield "batch", _decode_batch(payload)

    # -- GC ----------------------------------------------------------------
    def gc(self, applied_seq: int, n_terms: int) -> int:
        """Drop segments wholly covered by a checkpoint at
        ``applied_seq`` / ``n_terms`` dictionary entries.  The active
        segment always survives.  Returns segments removed."""
        removed = 0
        with self._lock:
            keep = []
            for path in self._segments[:-1]:
                st = self._stats[path]
                if st.max_seq <= applied_seq and st.max_mint_id < n_terms:
                    os.remove(path)
                    del self._stats[path]
                    removed += 1
                else:
                    keep.append(path)
            self._segments = keep + [self._segments[-1]]
        return removed

    # -- misc --------------------------------------------------------------
    @property
    def n_segments(self) -> int:
        with self._lock:
            return len(self._segments)

    def nbytes(self) -> int:
        self._fh.flush()
        with self._lock:
            return sum(os.path.getsize(p) for p in self._segments
                       if os.path.exists(p))

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
