"""The port's online compaction service against the JAX package's on the
same submissions: ``OnlineCompactionService`` step by step (batch
reports, epochs, seqs, dirty sets, drift state, metrics channels,
dictionary terms and digests), the interleaved-edits property, the
query engine's epoch-keyed buffers under ``rebind``, the write-ahead
journal and the checkpoints read across packages in both directions,
and the crash-point sweep over every fault site.

The reference is imported inside the ``R`` fixture (it pulls in jax),
so on a machine without jax this file still imports and every case
skips.  No property test here takes ``tmp_path``: a case that needs a
directory makes its own with ``tempfile``."""
import dataclasses
import os
import tempfile
import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.api import Compactor, DeviceBackend
from repro_torch.convert import store_from_arrays
from repro_torch.dist import fault
from repro_torch.online import (IngestBatch, IngestQueue, MetricsHub,
                                OnlineCompactionService, recover)
from repro_torch.online import wal as twal
from repro_torch.online.recovery import ckpt_dir
from repro_torch.online.wal import WAL_MAGIC
from repro_torch.query import QUERY_EXEC, QueryEngine, StarQuery


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    import repro.online as online
    import repro.online.recovery as recovery
    import repro.online.wal as wal
    from repro.api import Compactor as JCompactor
    from repro.data import synthetic as syn
    from repro.dist import fault as jfault
    from repro.query import batch as qbatch
    return types.SimpleNamespace(online=online, recovery=recovery, wal=wal,
                                 Compactor=JCompactor, syn=syn,
                                 fault=jfault, qbatch=qbatch)


def _pair(R, n=60, seed=5):
    ref = R.syn.generate(R.syn.SensorGraphSpec(n_observations=n, seed=seed))
    return ref, store_from_arrays(list(ref.dict._terms), ref.spo)


def _novel_batches(store, n):
    """Term-level batches of complete typed entities with pairwise-novel
    object tuples (each feeds support drift), every third batch deleting
    an earlier insert: the drift-heavy shape that makes re-detection
    run (the reference's recovery matrix)."""
    term = store.dict.term
    cid = int(store.classes()[0])
    props = np.asarray(store.class_properties(cid))
    cterm, tterm = term(cid), term(store.TYPE)
    pterms = [term(int(p)) for p in props]
    out = []
    for i in range(n):
        ins = []
        for j in range(3):
            s = f"e:n/b{i}/{j}"
            ins.append((s, tterm, cterm))
            ins += [(s, p, f"o:novel/b{i}/{j}/{k}")
                    for k, p in enumerate(pterms)]
        dels = [f"e:n/b{i - 2}/0"] if i % 3 == 2 else None
        out.append((ins, dels))
    return out


def _kw(backend="host", **extra):
    kw = dict(detector="gfsp", raw_residue_threshold=4,
              support_drift_threshold=3, retry_sleep=lambda _: None)
    kw["backend"] = DeviceBackend(device="cpu") if backend == "device" \
        else backend
    kw.update(extra)
    return kw


def _ref_kw(**extra):
    return _kw("host", **extra)


def batch_row(rep):
    """The integer content of a ``BatchReport``."""
    out = [rep.seq, rep.epoch_before, rep.epoch_after]
    if rep.update is not None:
        u = rep.update
        out.append(("update", u.n_new_triples, u.n_entities_absorbed,
                    u.n_new_surrogates, u.n_surrogates_reused, u.per_class,
                    u.touched_classes))
    if rep.delete is not None:
        out.append(("delete", dataclasses.asdict(rep.delete.stats)))
    if rep.redetect is not None:
        r = rep.redetect
        out.append(("redetect", r.considered, r.refactorized, r.epoch,
                    r.descents, r.per_class_savings, r.rejected,
                    r.edges_before, r.edges_after))
    return out


def channel_counts(svc):
    return {k: v["count"] for k, v in svc.metrics_summary().items()}


def same_service(jsvc, tsvc, what=""):
    js, ts = jsvc.snapshot, tsvc.snapshot
    assert ts.epoch == js.epoch, what
    assert ts.store.spo.tobytes() == js.store.spo.tobytes(), what
    assert ts.store.dict._terms == js.store.dict._terms, what
    assert ts.digest() == js.digest(), what
    assert tsvc.drift.state_dict() == jsvc.drift.state_dict(), what
    assert tsvc.applied_seq == jsvc.applied_seq, what
    assert tsvc.swap_count == jsvc.swap_count, what
    assert tsvc.queue.depth == jsvc.queue.depth, what


# ---------------------------------------------------------------------------
# the service, step by step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["host", "device", "device-recompress",
                                  "device-no-coalesce"])
def test_service_steps_match_reference(R, mode):
    """Ten batches (two submitted before each drain, so insert runs
    coalesce) through both services: the same batch reports, dirty sets
    and re-detections, swaps, drift counters, metrics channels and
    digests after every drain; and the same final state as a one-shot
    compaction of the net graph."""
    ref, store = _pair(R)
    extra = {}
    if mode.endswith("recompress"):
        extra["recompress_threshold"] = 40
    if mode.endswith("no-coalesce"):
        extra["coalesce"] = False
    backend = mode.split("-")[0]
    jsvc = R.online.OnlineCompactionService(ref, **_ref_kw(**extra))
    tsvc = OnlineCompactionService(store, **_kw(backend, **extra))
    same_service(jsvc, tsvc, "construction")
    seq = _novel_batches(ref, 10)
    n_redetect = 0
    for i in range(0, len(seq), 2):
        for ins, dels in seq[i:i + 2]:
            jb = jsvc.submit(inserts=ins, delete_entities=dels)
            tb = tsvc.submit(inserts=ins, delete_entities=dels)
            assert tb.seq == jb.seq
            assert tb.inserts.tobytes() == jb.inserts.tobytes()
            assert tb.delete_entities.tobytes() == \
                jb.delete_entities.tobytes()
        jreps, treps = jsvc.drain(), tsvc.drain()
        assert [batch_row(r) for r in treps] == \
            [batch_row(r) for r in jreps]
        n_redetect += sum(r.redetect is not None for r in treps)
        same_service(jsvc, tsvc, f"after batch {i + 1}")
        assert channel_counts(tsvc) == channel_counts(jsvc)
    assert n_redetect > 0
    if extra.get("recompress_threshold"):
        assert tsvc.metrics_summary()["ingest.recompressions"]["count"] > 0
    tsvc.snapshot.fgraph.validate()
    comp = Compactor("gfsp", "host")
    comp.run(tsvc.snapshot.fgraph.expand())
    assert comp.snapshot.digest() == tsvc.snapshot.digest()


def _clone_inserts(store, cid, tag, n, rng):
    term = store.dict.term
    props = np.asarray(store.class_properties(cid))
    _, mat = store.object_matrix(cid, props)
    pterms = [term(int(p)) for p in props]
    out, names = [], []
    for j in range(n):
        row = mat[int(rng.integers(0, mat.shape[0]))]
        s = f"e:t/{tag}/{j}"
        names.append(s)
        out.append((s, term(store.TYPE), term(cid)))
        out += [(s, p, term(int(o))) for p, o in zip(pterms, row)]
    return out, names


def _novel_inserts(store, cid, tag, n):
    term = store.dict.term
    pterms = [term(int(p)) for p in store.class_properties(cid)]
    out, names = [], []
    for j in range(n):
        s = f"e:n/{tag}/{j}"
        names.append(s)
        out.append((s, term(store.TYPE), term(cid)))
        out += [(s, p, f"o:novel/{tag}/{j}/{k}")
                for k, p in enumerate(pterms)]
    return out, names


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**16),
       ops=st.lists(st.tuples(st.integers(0, 2),      # reuse inserts
                              st.integers(0, 3),      # novel inserts
                              st.booleans()),         # delete earlier?
                    min_size=1, max_size=4))
def test_interleaved_edits_digest_parity(R, seed, ops):
    """The reference's interleaved-edits property on the port (device
    backend on the CPU), beside the reference's own service on the same
    ops: any interleaving of update/delete batches with auto
    re-detection ends digest-identical to a one-shot compaction of the
    net graph, and to the reference service, batch report by batch
    report."""
    ref, store = _pair(R, 30, seed=4)
    kw = dict(support_drift_threshold=3, raw_residue_threshold=4)
    jsvc = R.online.OnlineCompactionService(ref, detector="gfsp",
                                            backend="host", **kw)
    tsvc = OnlineCompactionService(store, detector="gfsp",
                                   backend=DeviceBackend(device="cpu"), **kw)
    rng = np.random.default_rng(seed)
    cids = [ref.dict.lookup("ssn:Observation"),
            ref.dict.lookup("ssn:Measurement")]
    inserted: list[str] = []
    for b, (n_reuse, n_novel, do_delete) in enumerate(ops):
        cid = cids[b % 2]
        ins = []
        if n_reuse:
            tri, names = _clone_inserts(ref, cid, f"{seed}/{b}", n_reuse,
                                        rng)
            ins += tri
            inserted += names
        if n_novel:
            tri, names = _novel_inserts(ref, cid, f"{seed}/{b}", n_novel)
            ins += tri
            inserted += names
        if ins:
            jsvc.submit(inserts=ins)
            tsvc.submit(inserts=ins)
        if do_delete and inserted:
            k = min(len(inserted), 3)
            dels = [inserted.pop(int(rng.integers(0, len(inserted))))
                    for _ in range(k)]
            jsvc.submit(delete_entities=dels)
            tsvc.submit(delete_entities=dels)
        assert [batch_row(r) for r in tsvc.drain()] == \
            [batch_row(r) for r in jsvc.drain()]
        same_service(jsvc, tsvc, f"batch {b}")
    assert tsvc.queue.depth == 0
    comp = Compactor(detector="gfsp", backend="host")
    comp.run(tsvc.snapshot.fgraph.expand())
    assert comp.snapshot.digest() == tsvc.snapshot.digest()


def test_unknown_deletes_and_id_submissions_are_counted_alike(R):
    ref, store = _pair(R)
    jsvc = R.online.OnlineCompactionService(ref, **_ref_kw())
    tsvc = OnlineCompactionService(store, **_kw("device"))
    cid = next(iter(sorted(tsvc.snapshot.fgraph.tables)))
    ins, names = _novel_inserts(ref, cid, "ud", 3)
    for svc in (jsvc, tsvc):
        svc.submit(inserts=ins)
        svc.drain()
        svc.submit(delete_entities=[names[0], "e:never/one", "e:never/two"])
        svc.submit(delete_triples=[("e:ghost", "p:ghost", "o:ghost")])
        svc.submit(delete_entities=np.asarray([], np.int64))
        svc.drain()
    assert tsvc.metrics_summary()["ingest.unknown_deletes"] == \
        jsvc.metrics_summary()["ingest.unknown_deletes"]
    same_service(jsvc, tsvc)


# ---------------------------------------------------------------------------
# the query engine across snapshot swaps
# ---------------------------------------------------------------------------

def test_rebind_evicts_like_the_reference(R):
    """A device query engine rebound after every swap keeps the buffers
    of the latest two epochs only: the same evictions, buffer keys,
    ``QUERY_EXEC`` counts and answers as the reference's engine."""
    ref, store = _pair(R)
    jsvc = R.online.OnlineCompactionService(ref, **_ref_kw())
    tsvc = OnlineCompactionService(store, **_kw("device"))
    jm, tm = R.online.MetricsHub(), MetricsHub()
    jeng = R.qbatch.QueryEngine(jsvc.fgraph, use_kernel=False,
                                epoch=jsvc.snapshot.epoch, metrics=jm)
    teng = QueryEngine(tsvc.fgraph, device="cpu",
                       epoch=tsvc.snapshot.epoch, metrics=tm)
    R.qbatch.reset_query_stats()
    from repro_torch.query import reset_query_stats
    reset_query_stats()
    for ins, dels in _novel_batches(ref, 7):
        for svc, eng in ((jsvc, jeng), (tsvc, teng)):
            svc.submit(inserts=ins, delete_entities=dels)
            svc.drain()
            eng.rebind(svc.fgraph, svc.snapshot.epoch)
        qs = []
        for cid, t in sorted(tsvc.fgraph.tables.items()):
            for r in (0, t.n_molecules - 1):
                qs.append(StarQuery(arms=tuple(
                    (p, int(o)) for p, o in zip(t.props, t.objects[r])),
                    class_id=cid))
        got = teng.query_batch(qs, backend="device")
        want = jeng.query_batch(qs, backend="device")
        for g, w in zip(got, want):
            assert np.array_equal(g.canonical(), w.canonical())
        assert sorted(teng._bufs) == sorted(jeng._bufs)
        assert teng.buffer_evictions == jeng.buffer_evictions
    assert teng.buffer_evictions > 0
    assert dict(QUERY_EXEC) == dict(R.qbatch.QUERY_EXEC)
    assert tm.summary() == jm.summary()
    teng.rebind(tsvc.fgraph, tsvc.snapshot.epoch)       # same: a no-op
    assert teng.buffer_evictions == jeng.buffer_evictions


# ---------------------------------------------------------------------------
# the journal, across packages
# ---------------------------------------------------------------------------

def _batch(seq, n_ins=2, base=100):
    rng = np.random.default_rng(seq + base)
    return (seq, rng.integers(0, 99, (n_ins, 3)).astype(np.int32),
            rng.integers(0, 99, (seq % 2, 3)).astype(np.int32),
            np.asarray([seq * 7], np.int64))


def _write_journal(walmod, batch_cls, root, **kw):
    wal = walmod.DurableWAL(root, **kw)
    for seq in range(8):
        wal.append_mints([(100 + seq, f"ex:m{seq}"), (200 + seq, "lit:é")])
        s, ins, dt, de = _batch(seq)
        wal.append_batch(batch_cls(seq=s, inserts=ins, delete_triples=dt,
                                   delete_entities=de))
        wal.append_applied([seq] if seq % 3 else [seq - 1, seq])
    wal.close()


def _segments(root):
    out = {}
    for n in sorted(os.listdir(root)):
        with open(os.path.join(root, n), "rb") as f:
            out[n] = f.read()
    return out


def _records(walmod, root):
    wal = walmod.DurableWAL(root)
    out = []
    for kind, rec in wal.replay():
        if kind == "batch":
            rec = (rec.seq, rec.inserts.tobytes(),
                   rec.delete_triples.tobytes(),
                   rec.delete_entities.tobytes())
        out.append((kind, rec))
    stats = (wal.truncated_bytes, wal.dropped_segments, wal.n_segments)
    wal.close()
    return out, stats


@pytest.mark.parametrize("seg_bytes", [4 << 20, 256])
def test_wal_segments_are_byte_equal_and_cross_read(R, seg_bytes):
    with tempfile.TemporaryDirectory() as tmp:
        jroot, troot = os.path.join(tmp, "j"), os.path.join(tmp, "t")
        _write_journal(R.wal, R.wal.IngestBatch, jroot,
                       segment_max_bytes=seg_bytes)
        _write_journal(twal, IngestBatch, troot,
                       segment_max_bytes=seg_bytes)
        js, ts = _segments(jroot), _segments(troot)
        assert ts == js
        assert (len(ts) > 2) == (seg_bytes == 256)
        want = _records(R.wal, jroot)
        assert _records(twal, jroot) == want        # reference -> port
        assert _records(R.wal, troot) == want       # port -> reference
        assert [k for k, _ in want[0]][:3] == ["mint", "batch", "apply"]


# a cut inside the tail record, a cut inside its header, a flipped
# payload byte, a flipped header byte, and a whole-record cut
TORN = [(-3, None), (-(12 + 4), None), (None, -5), (None, -30),
        (-40, None)]


@pytest.mark.parametrize("cut,flip", TORN)
def test_wal_torn_tail_truncates_like_the_reference(R, cut, flip):
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "src")
        _write_journal(R.wal, R.wal.IngestBatch, src)
        (name, data), = _segments(src).items()
        if cut is not None:
            data = data[:cut]
        else:
            data = bytearray(data)
            data[flip] ^= 0x5A
            data = bytes(data)
        results = []
        for walmod, sub in ((R.wal, "j"), (twal, "t")):
            root = os.path.join(tmp, sub)
            os.makedirs(root)
            with open(os.path.join(root, name), "wb") as f:
                f.write(data)
            results.append((_records(walmod, root), _segments(root)))
        assert results[1] == results[0]
        (recs, (truncated, dropped, _)), _ = results[1]
        assert truncated > 0 and dropped == 0
        assert recs and recs[-1][0] in ("mint", "batch", "apply")


def test_wal_bad_magic_drops_the_segment_and_later_ones(R):
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "src")
        _write_journal(R.wal, R.wal.IngestBatch, src, segment_max_bytes=256)
        segs = _segments(src)
        names = sorted(segs)
        bad = names[2]
        segs[bad] = b"FSPWAL99" + segs[bad][len(WAL_MAGIC):]
        results = []
        for walmod, sub in ((R.wal, "j"), (twal, "t")):
            root = os.path.join(tmp, sub)
            os.makedirs(root)
            for n, d in segs.items():
                with open(os.path.join(root, n), "wb") as f:
                    f.write(d)
            results.append((_records(walmod, root), _segments(root)))
        assert results[1] == results[0]
        (recs, (truncated, dropped, n_seg)), left = results[1]
        assert dropped == len(names) - 3 and truncated > 0
        # the emptied segment reopens as the active one, magic rewritten
        assert sorted(left) == names[:3] and left[bad] == WAL_MAGIC


# ---------------------------------------------------------------------------
# checkpoints and recovery, across packages
# ---------------------------------------------------------------------------

def _run_durable(svc, seq):
    for ins, dels in seq:
        svc.submit(inserts=ins, delete_entities=dels)
        svc.drain()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_written_by_one_package_recovers_in_the_other(R, writer):
    """A durable service of one package ingests six batches (an async
    checkpoint every three) and one more journaled but unapplied; the
    other package recovers the root to the same digest, epoch, drift
    state and pending queue, and both then ingest the rest alike.  The
    two packages' checkpoints of the same step hold the same files."""
    ref, store = _pair(R)
    seq = _novel_batches(ref, 10)
    with tempfile.TemporaryDirectory() as tmp:
        roots = {k: os.path.join(tmp, k) for k in ("j", "t")}
        jsvc = R.online.OnlineCompactionService.durable(
            roots["j"], ref, checkpoint_every=3, **_ref_kw())
        tsvc = OnlineCompactionService.durable(
            roots["t"], store, checkpoint_every=3, **_kw("device"))
        for svc in (jsvc, tsvc):
            _run_durable(svc, seq[:6])
            svc.submit(inserts=seq[6][0], delete_entities=seq[6][1])
            svc.checkpoint(wait=True)
            svc.close()
        same_service(jsvc, tsvc, "before the crash")
        ck = {k: R.recovery.SnapshotCheckpointer(ckpt_dir(r))
              for k, r in roots.items()}
        steps = ck["t"].steps()
        assert steps == ck["j"].steps() and steps
        for s in steps:
            assert ck["t"].validate(s)["files"] == \
                ck["j"].validate(s)["files"]
        root = roots["j" if writer == "reference" else "t"]
        want = jsvc if writer == "reference" else tsvc
        other = recover(root, **_kw("device")) if writer == "reference" \
            else R.online.recover(root, **_ref_kw())
        assert other.snapshot.digest() == want.snapshot.digest()
        assert other.snapshot.epoch == want.snapshot.epoch
        assert other.drift.state_dict() == want.drift.state_dict()
        assert other.queue.depth == 1 and other.applied_seq == 5
        twin = R.online.recover(roots["j"], **_ref_kw())
        for svc in (other, twin):
            svc.drain()
            _run_durable(svc, seq[7:])
            svc.close()
        assert other.snapshot.digest() == twin.snapshot.digest()
        assert other.snapshot.store.dict._terms == \
            twin.snapshot.store.dict._terms


def _crash_cell(online, faults, store, seq, root, site, occ, kw):
    """One cell of the recovery matrix in one package: a durable service
    crashed at ``site``'s ``occ``-th visit, recovered from disk, the
    batch resubmitted; returns the final service and whether it
    crashed."""
    svc = online.OnlineCompactionService.durable(
        root, store, fault_plan=faults.FaultPlan(site, occurrence=occ),
        checkpoint_every=3, checkpoint_async=False, **kw)
    crashed = False
    for ins, dels in seq:
        for _ in range(2):
            try:
                svc.submit(inserts=ins, delete_entities=dels)
                svc.drain()
                break
            except faults.InjectedFault:
                crashed = True
                svc = online.recover(root, **kw)
        else:
            raise AssertionError(f"{site} kept crashing")
    svc.close()
    return svc, crashed


_REF_DIGEST: dict = {}


@pytest.mark.parametrize("occ", [0, 1])
@pytest.mark.parametrize("site", fault.SITES)
def test_crash_sweep_recovers_like_the_reference(R, site, occ):
    """The reference's recovery matrix (60 observations, 10 batches,
    sync checkpoints every 3 applies): a crash at each fault site and
    occurrence, recovery from disk, the batch resubmitted.  The port on
    the device backend crashes where the reference does, recovers with
    the same ``RecoveryReport`` counts, and ends drained and digest-equal
    to an uninterrupted run."""
    import repro_torch.online as tonline
    ref, store = _pair(R)
    seq = _novel_batches(ref, 10)
    if "digest" not in _REF_DIGEST:
        svc = R.online.OnlineCompactionService(ref, **_ref_kw())
        _run_durable(svc, seq)
        _REF_DIGEST["digest"] = svc.snapshot.digest()

    out, files = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ref_store, port_store = _pair(R)
        for name, mod, faults, store, kw in (
                ("j", R.online, R.fault, ref_store, _ref_kw()),
                ("t", tonline, fault, port_store, _kw("device"))):
            root = os.path.join(tmp, name)
            out[name] = _crash_cell(mod, faults, store, seq, root, site, occ,
                                    kw)
            ck = R.recovery.SnapshotCheckpointer(ckpt_dir(root))
            files[name] = {s: ck.validate(s)["files"] for s in ck.steps()}
    assert files["t"] == files["j"] and files["t"]
    (jsvc, jcrashed), (tsvc, tcrashed) = out["j"], out["t"]
    assert tcrashed and jcrashed
    assert tsvc.queue.depth == 0
    assert tsvc.snapshot.digest() == _REF_DIGEST["digest"]
    assert tsvc.snapshot.digest() == jsvc.snapshot.digest()
    jr, tr = jsvc.last_recovery, tsvc.last_recovery
    assert (tr is None) == (jr is None)
    if tr is not None:
        jd, td = jr.as_dict(), tr.as_dict()
        jd.pop("replay_ms"), td.pop("replay_ms")
        # the manifest holds a wall-clock timestamp whose decimal digits
        # vary by a few bytes; every other checkpoint file is equal above
        jb, tb = jd.pop("checkpoint_bytes"), td.pop("checkpoint_bytes")
        assert abs(tb - jb) < 8 and tb > 0
        assert td == jd
    assert tsvc.snapshot.store.dict._terms == jsvc.snapshot.store.dict._terms


# ---------------------------------------------------------------------------
# fault plans, the queue
# ---------------------------------------------------------------------------

def test_fault_plans_and_retry_match_the_reference(R):
    for seed in range(40):
        t, j = fault.FaultPlan.seeded(seed), R.fault.FaultPlan.seeded(seed)
        assert (t.site, t.occurrence, t.mode) == (j.site, j.occurrence,
                                                  j.mode)
    with pytest.raises(ValueError):
        fault.FaultPlan("nowhere")
    with pytest.raises(ValueError):
        fault.FaultPlan("apply", mode="sometimes")
    plan = fault.FaultPlan("apply", occurrence=1)
    plan.fire("apply")
    with pytest.raises(fault.InjectedFault):
        plan.fire("apply")
    plan.fire("apply")                               # fires once only
    assert plan.seen("apply") == 3 and plan.fired

    def trace(mod):
        calls, sleeps = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return len(calls)

        import random
        got = mod.retry(flaky, attempts=4, base_s=0.5, sleep=sleeps.append,
                        rng=random.Random(3))()
        return got, sleeps

    assert trace(fault) == trace(R.fault)

    events = []
    now = [0.0]
    mon = fault.Monitor(deadline_s=5, straggler_factor=2,
                        on_dead=lambda w: events.append(("dead", w)),
                        on_straggler=lambda w: events.append(("slow", w)),
                        clock=lambda: now[0])
    mon.record("a", 5)
    mon.record("b", 1)
    mon.check()
    now[0] = 10.0
    mon.record("b", 6)
    mon.check()
    assert events == [("slow", "b"), ("dead", "a")]
    assert mon.healthy_workers() == ["b"]


def test_queue_coalescing_matches_the_reference(R):
    tq, jq = IngestQueue(), R.wal.IngestQueue()
    for q in (tq, jq):
        q.append(inserts=np.zeros((1, 3), np.int32))
        q.append(inserts=np.ones((2, 3), np.int32))
        q.append(delete_entities=np.asarray([7], np.int64))
        q.append(inserts=np.ones((1, 3), np.int32))
    for m in (None, 1, 2):
        assert [b.seq for b in tq.peek_coalesced(m)] == \
            [b.seq for b in jq.peek_coalesced(m)]
    with pytest.raises(ValueError):
        tq.mark_applied(1)
    tq.mark_applied_through([0, 1, 2])
    assert tq.depth == 1 and tq.n_applied == 3 and tq.peek().seq == 3
    fresh = IngestQueue()
    with pytest.raises(ValueError):
        fresh.restore([tq.peek(), tq.peek()])


def test_device_service_raises_without_cuda(monkeypatch):
    """``backend="device"`` means the card: without one the service
    refuses to start instead of running the plain kernels on the CPU."""
    import torch
    from repro_torch.data.synthetic import SensorGraphSpec, generate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = generate(SensorGraphSpec(n_observations=30, seed=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OnlineCompactionService(store, backend="device")
    svc = OnlineCompactionService(store, backend="host")
    assert svc.planner.backend.name == "host"
