"""Sharded ``FactorizedGraph``: partition the compact form across a mesh.

Every multi-device path so far shards only the sweep *math* -- triples,
molecule tables and the dictionary stay replicated on host.  This module
partitions the graph itself, exploiting exactly the structure the
factorized form already has:

* **typed entities partition by class** (molecule tables + instanceOf
  CSR become shard-local): every row whose subject carries a ``type``
  edge routes to the *owner shard* of that subject, where the owner
  class is the subject's minimum class id.  Keeping each entity's whole
  star co-located is what makes shard-local detection AND per-class
  query routing exact -- a molecule never straddles shards;
* **untyped-subject rows partition by predicate** (the substrate's
  vertical-partition CSR columns): a row with no typed subject routes to
  the owner shard of its predicate, so classless var-arm scans touch one
  shard per predicate;
* a :class:`ShardPlan` balances the shards on Def. 4.8 edge counts
  (per-entity row counts are exactly the entity's edge contribution).
  Classes bigger than the balance target are *chunk-split* at cumulative
  edge-weight boundaries and the chunks placed LPT-greedy, so a two-
  class workload still fills an 8-way mesh.

Detection then runs **shard-local** through the existing
``SweepWorkspace``/``sweep_candidates`` engine (each shard is an
ordinary ``CompactionPlanner.run`` over its sub-store, with a per-shard
surrogate prefix so mints never collide in the shared dictionary); the
``ami_bucketed_batch`` collective schedule is engaged only where a
class's entity universe crosses shards (:meth:`cross_shard_ami` -- one
hash-bucket ``all_to_all``, signatures cross shards exactly once).
Chunk-splitting a class is AMI-exact for detection because the digest /
Def. 4.11 semantics are invariant to *how* the population is cut: each
chunk detects its own frequent star over the same property universe and
the union of expansions is the original graph (asserted in
``tests/test_sharded.py``).

Queries fan out per shard and only *binding sets* cross shards: star
results concatenate (typed subjects are uniquely owned), classless arms
merge per-arm ``(s, v)`` pair sets, and BGP stars evaluate to concrete
per-shard relations that join at the coordinator.

The port of ``repro/dist/graph.py``.  Collectives run on a
:mod:`repro_torch.dist.mesh` mesh of torch devices, reached lazily via
``repro_torch.core.distributed``; detection and queries run on the
device backend on ``device`` (default ``"cuda"``) when asked, and a
forked parallel detection refuses a device backend on CUDA (a forked
child cannot use its parent's CUDA context).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Sequence

import numpy as np

from ..core.index import SPO_PERM, csr_take, in_sorted, sort_unique
from ..core.triples import TripleStore

# fork-shared worker context for parallel shard detection: the child
# processes read it copy-on-write, so the (possibly large) shard
# snapshots are never pickled
_FORK_CTX: dict = {}


# ---------------------------------------------------------------------------
# the shard plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static row-routing plan balanced on Def. 4.8 edge counts.

    ``owner_entities`` (sorted) / ``owner_shard`` give the typed-subject
    routing; ``pred_shard`` routes untyped-subject rows by predicate;
    ``class_shards`` is the query-routing view (every shard holding at
    least one entity of the class, multi-typed entities included);
    ``class_props`` freezes each class's property universe at build time
    so cross-shard AMI evaluates every chunk over the same columns.
    """

    n_shards: int
    owner_entities: np.ndarray          # (E,) int64, sorted
    owner_shard: np.ndarray             # (E,) int32, aligned
    pred_shard: dict[int, int]
    class_shards: dict[int, tuple[int, ...]]
    class_props: dict[int, tuple[int, ...]]
    shard_weights: tuple[int, ...]      # Def. 4.8 edge-count loads
    n_chunks: int                       # entity chunks placed (>= classes)

    @classmethod
    def build(cls, store: TripleStore, n_shards: int, *,
              oversplit: int = 2) -> "ShardPlan":
        """Balance on per-entity edge counts with class chunk-splitting.

        A class whose weight exceeds ``total / (n_shards * oversplit)``
        splits into equal-weight entity-range chunks; chunks (plus the
        untyped per-predicate column groups) are placed LPT-greedy on
        the least-loaded shard.
        """
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        idx = store.index
        spo = store.spo
        trows = idx.pred_slice(store.TYPE)
        if trows.shape[0]:
            # the (s, o)-sorted type partition: first row per subject
            # carries its minimum class id -- the owner class
            ents, first = np.unique(trows[:, 0], return_index=True)
            ents = ents.astype(np.int64)
            owner_class = trows[first, 2].astype(np.int64)
        else:
            ents = np.empty((0,), np.int64)
            owner_class = np.empty((0,), np.int64)
        subs = spo[:, 0].astype(np.int64)
        lo = np.searchsorted(subs, ents, side="left")
        hi = np.searchsorted(subs, ents, side="right")
        w = (hi - lo).astype(np.int64)           # per-entity edge count
        typed_mask = in_sorted(subs, ents)
        upreds, ucounts = (np.unique(spo[~typed_mask, 1],
                                     return_counts=True)
                           if (~typed_mask).any()
                           else (np.empty(0, np.int64),
                                 np.empty(0, np.int64)))
        total = int(w.sum()) + int(ucounts.sum())
        target = max(1, -(-total // max(n_shards * oversplit, 1)))
        items: list[tuple[int, str, object]] = []
        n_chunks = 0
        for cid in np.unique(owner_class).tolist():
            m = owner_class == cid
            ce, cw = ents[m], w[m]
            wc = int(cw.sum())
            k = min(max(1, -(-wc // target)), n_shards * oversplit,
                    int(ce.shape[0]))
            if k <= 1:
                items.append((wc, "ents", ce))
                n_chunks += 1
                continue
            cum = np.cumsum(cw)
            cuts = np.searchsorted(
                cum, [wc * j // k for j in range(1, k)], side="left") + 1
            prev = 0
            for b in list(int(c) for c in cuts) + [int(ce.shape[0])]:
                b = min(max(b, prev), int(ce.shape[0]))
                if b > prev:
                    items.append((int(cw[prev:b].sum()), "ents",
                                  ce[prev:b]))
                    n_chunks += 1
                    prev = b
        for p, c in zip(upreds.tolist(), ucounts.tolist()):
            items.append((int(c), "pred", int(p)))
        # LPT greedy: heaviest item first onto the least-loaded shard
        items.sort(key=lambda it: -it[0])
        loads = [0] * n_shards
        owner_shard = np.zeros((ents.shape[0],), np.int32)
        pred_shard: dict[int, int] = {}
        for wt, kind, payload in items:
            sid = int(np.argmin(loads))
            loads[sid] += wt
            if kind == "ents":
                pos = np.searchsorted(ents, payload)
                owner_shard[pos] = sid
            else:
                pred_shard[int(payload)] = sid
        class_shards: dict[int, tuple[int, ...]] = {}
        class_props: dict[int, tuple[int, ...]] = {}
        for cid in (int(c) for c in store.classes()):
            ec = idx.entities_of_class(cid).astype(np.int64)
            if ec.shape[0] == 0:
                continue
            if ents.shape[0]:
                pos = np.searchsorted(ents, ec)
                pos = np.minimum(pos, ents.shape[0] - 1)
                known = ents[pos] == ec
                shards = (np.unique(owner_shard[pos[known]])
                          if known.any() else np.empty(0, np.int32))
            else:
                shards = np.empty(0, np.int32)
            class_shards[cid] = tuple(int(s) for s in shards)
            stats = store.class_stats(cid)
            class_props[cid] = tuple(
                int(p) for p in np.sort(np.asarray(stats.properties)))
        return cls(n_shards=n_shards, owner_entities=ents,
                   owner_shard=owner_shard, pred_shard=pred_shard,
                   class_shards=class_shards, class_props=class_props,
                   shard_weights=tuple(int(x) for x in loads),
                   n_chunks=n_chunks)

    @property
    def split_classes(self) -> tuple[int, ...]:
        """Classes whose entity universe crosses shards -- the ones the
        collective AMI schedule covers."""
        return tuple(c for c, s in sorted(self.class_shards.items())
                     if len(s) > 1)

    def shards_for_class(self, class_id: int) -> tuple[int, ...]:
        return self.class_shards.get(
            int(class_id), tuple(range(self.n_shards)))

    def route_rows(self, spo: np.ndarray) -> np.ndarray:
        """Shard id per row: typed subjects to their owner shard,
        untyped rows to their predicate's shard."""
        spo = np.asarray(spo).reshape(-1, 3)
        n = spo.shape[0]
        out = np.zeros((n,), np.int32)
        if n == 0:
            return out
        subs = spo[:, 0].astype(np.int64)
        if self.owner_entities.shape[0]:
            pos = np.searchsorted(self.owner_entities, subs)
            pos_c = np.minimum(pos, self.owner_entities.shape[0] - 1)
            typed = (pos < self.owner_entities.shape[0]) & \
                (self.owner_entities[pos_c] == subs)
            out[typed] = self.owner_shard[pos_c[typed]]
        else:
            typed = np.zeros((n,), bool)
        rest = ~typed
        if rest.any():
            preds = spo[rest, 1]
            ps = np.empty((int(rest.sum()),), np.int32)
            for p in np.unique(preds).tolist():
                ps[preds == p] = self.pred_shard.get(
                    int(p), int(p) % self.n_shards)
            out[rest] = ps
        return out


# ---------------------------------------------------------------------------
# parallel shard detection (fork workers, shared-dict remap)
# ---------------------------------------------------------------------------

def _remap_ids(a: np.ndarray, base: int, new_ids: np.ndarray) -> np.ndarray:
    """Rewrite worker-minted ids (>= ``base``) to their parent-dict ids."""
    out = np.asarray(a, np.int64).copy()
    m = out >= base
    if m.any():
        out[m] = new_ids[out[m] - base]
    return out


def _detect_shard_worker(sid: int):
    """Runs in a fork child: compact one shard, return its successor
    snapshot as (arrays, meta) plus the terms it minted past the fork
    point (the parent re-mints them into the shared dictionary and
    rewrites the ids)."""
    from ..api.snapshot import CompactionPlanner, GraphSnapshot
    snap = _FORK_CTX["snaps"][sid]
    kw = _FORK_CTX["kw"]
    store = (snap.fgraph.store if not snap.fgraph.tables
             else snap.fgraph.expand())
    base = len(store.dict)
    if kw["backend_opts"]:
        # the device backend on the CPU: torch's intra-op pool does not
        # survive a fork, so the child runs its ops on one thread
        import torch
        torch.set_num_threads(1)
    planner = CompactionPlanner(
        kw["detector"], kw["backend"],
        min_predicted_savings=kw["min_predicted_savings"],
        surrogate_prefix=f"{kw['surrogate_prefix']}/s{sid}",
        backend_opts=kw["backend_opts"])
    # CPU time, not wall: concurrent workers time-slicing fewer cores
    # would otherwise bill each other's share into every shard's number
    t0 = time.process_time()
    new_snap, rep = planner.run(store)
    detect_ms = (time.process_time() - t0) * 1e3
    arrays, meta = GraphSnapshot(fgraph=new_snap.fgraph,
                                 epoch=snap.epoch + 1).to_state()
    d = store.dict
    minted = [d.term(i) for i in range(base, len(d))]
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    report = {"n_before": int(rep.n_triples_before),
              "n_after": int(rep.n_triples_after),
              "classes": len(new_snap.fgraph.tables),
              "pct_savings": float(rep.pct_savings_triples),
              "detect_ms": round(detect_ms, 1)}
    return sid, arrays, meta, minted, base, report


# ---------------------------------------------------------------------------
# the sharded graph
# ---------------------------------------------------------------------------

class ShardedFactorizedGraph:
    """Per-shard :class:`~repro_torch.api.snapshot.GraphSnapshot` tuple over a
    shared dictionary, swapped atomically (one attribute store) under
    the same epoch discipline as the replicated snapshot path."""

    def __init__(self, dictionary, plan: ShardPlan,
                 snapshots: Sequence) -> None:
        self.dict = dictionary
        self.plan = plan
        self._snaps = tuple(snapshots)
        if len(self._snaps) != plan.n_shards:
            raise ValueError("snapshot count does not match the plan")
        # cross-shard byte accounting (filled by collective AMI and the
        # query fan-out merge; the bench matrix records it)
        self.traffic = {"detect_bytes": 0, "query_bytes": 0,
                        "collective_calls": 0}

    # -- construction ------------------------------------------------------
    @classmethod
    def partition(cls, store: TripleStore, n_shards: int, *,
                  plan: ShardPlan | None = None,
                  oversplit: int = 2) -> "ShardedFactorizedGraph":
        """Route every row of a plain store to its shard (disjoint row
        partition; a row subset of the sorted spo stays sorted)."""
        from ..api.snapshot import GraphSnapshot
        from ..core.fgraph import FactorizedGraph
        if plan is None:
            plan = ShardPlan.build(store, n_shards, oversplit=oversplit)
        sids = plan.route_rows(store.spo)
        snaps = []
        for sid in range(plan.n_shards):
            sub = TripleStore.from_ids(store.dict,
                                       store.spo[sids == sid],
                                       presorted=True)
            snaps.append(GraphSnapshot(fgraph=FactorizedGraph(sub, {}),
                                       epoch=0))
        return cls(store.dict, plan, snaps)

    # -- snapshot discipline -----------------------------------------------
    @property
    def snapshots(self) -> tuple:
        return self._snaps

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    @property
    def epoch(self) -> int:
        return max(s.epoch for s in self._snaps)

    def swap(self, snapshots: Sequence) -> None:
        """THE commit: one atomic attribute store of the whole tuple --
        a reader holding the old tuple keeps a consistent world view."""
        snaps = tuple(snapshots)
        if len(snaps) != self.plan.n_shards:
            raise ValueError("snapshot count does not match the plan")
        self._snaps = snaps

    def swap_shard(self, sid: int, snapshot) -> None:
        """Replace one shard's snapshot (still one atomic tuple store)."""
        snaps = list(self._snaps)
        snaps[int(sid)] = snapshot
        self._snaps = tuple(snaps)

    # -- detection ---------------------------------------------------------
    def detect_all(self, *, detector: str = "gfsp",
                   backend: str = "host",
                   min_predicted_savings: int = 1,
                   surrogate_prefix: str = "repro:sg",
                   parallel: bool = False, mesh=None,
                   device="cuda") -> dict:
        """Shard-local detection through the existing sweep engine.

        Each shard compacts independently (per-shard surrogate prefix,
        shared dictionary); ``backend="device"`` sweeps on ``device``
        (default ``"cuda"``).  With a ``mesh``, the classes whose entity
        universe crosses shards first run the ``ami_bucketed_batch``
        exchange -- the only step where signatures cross shards -- and
        the global AMI lands in the report.  ``parallel=True`` forks one
        worker per shard (host detection is numpy-only, fork-safe);
        workers return snapshot state plus their minted terms, which the
        parent re-mints into the shared dictionary and rewrites, so the
        shared-dict invariant survives process-parallel detection.  A
        forked child cannot use the parent's CUDA context, so
        ``parallel=True`` with a device backend on CUDA raises.
        """
        backend_opts = None
        if backend in ("device", "sharded"):
            from ..kernels.ops import resolve_device
            device = resolve_device(device)
            backend_opts = {"device": device}
            if parallel and self.n_shards > 1 and device.type == "cuda":
                raise ValueError(
                    "detect_all(parallel=True) forks its workers, and a "
                    "forked child cannot use the CUDA context of its "
                    f"parent: run backend={backend!r} on {device} with "
                    "parallel=False, or the host backend in parallel")
        report: dict = {"split_class_ami": {}, "shards": {}}
        for cid in self.plan.split_classes:
            report["split_class_ami"][int(cid)] = self.cross_shard_ami(
                cid, mesh=mesh)
        kw = dict(detector=detector, backend=backend,
                  backend_opts=backend_opts,
                  min_predicted_savings=int(min_predicted_savings),
                  surrogate_prefix=surrogate_prefix)
        if parallel and self.n_shards > 1:
            report["shards"] = self._detect_parallel(kw)
        else:
            report["shards"] = self._detect_sequential(kw)
        return report

    def _detect_sequential(self, kw: dict) -> dict:
        from ..api.snapshot import CompactionPlanner, GraphSnapshot
        snaps = list(self._snaps)
        out = {}
        for sid, snap in enumerate(snaps):
            planner = CompactionPlanner(
                kw["detector"], kw["backend"],
                min_predicted_savings=kw["min_predicted_savings"],
                surrogate_prefix=f"{kw['surrogate_prefix']}/s{sid}",
                backend_opts=kw["backend_opts"])
            store = (snap.fgraph.store if not snap.fgraph.tables
                     else snap.fgraph.expand())
            t0 = time.process_time()
            new_snap, rep = planner.run(store)
            detect_ms = (time.process_time() - t0) * 1e3
            snaps[sid] = GraphSnapshot(fgraph=new_snap.fgraph,
                                       epoch=snap.epoch + 1)
            out[sid] = {"n_before": int(rep.n_triples_before),
                        "n_after": int(rep.n_triples_after),
                        "classes": len(new_snap.fgraph.tables),
                        "pct_savings": float(rep.pct_savings_triples),
                        "detect_ms": round(detect_ms, 1)}
        self.swap(snaps)
        return out

    def _detect_parallel(self, kw: dict) -> dict:
        import concurrent.futures
        import multiprocessing as mp
        from ..api.snapshot import GraphSnapshot
        ctx = mp.get_context("fork")
        _FORK_CTX["snaps"] = self._snaps
        _FORK_CTX["kw"] = kw
        try:
            with concurrent.futures.ProcessPoolExecutor(
                    max_workers=self.n_shards,
                    mp_context=ctx) as ex:
                results = list(ex.map(_detect_shard_worker,
                                      range(self.n_shards)))
        finally:
            _FORK_CTX.clear()
        snaps = list(self._snaps)
        out = {}
        for sid, arrays, meta, minted, base, rep in results:
            new_ids = (self.dict.ids(minted).astype(np.int64)
                       if minted else np.empty((0,), np.int64))
            fixed: dict[str, np.ndarray] = {}
            for k, v in arrays.items():
                if k == "spo":
                    # remapped mints can break (s, p, o) order: re-sort
                    fixed[k] = sort_unique(
                        _remap_ids(v, base, new_ids).astype(np.int32),
                        SPO_PERM)
                elif k.endswith("_surrogates"):
                    # parent re-mints in worker mint order, so the map
                    # is monotone and ascending surrogates stay sorted
                    fixed[k] = _remap_ids(v, base,
                                          new_ids).astype(np.int32)
                else:
                    fixed[k] = v        # object ids predate the fork
            snaps[sid] = GraphSnapshot.from_state(self.dict, fixed, meta)
            out[sid] = rep
        self.swap(snaps)
        return out

    # -- cross-shard collective AMI ---------------------------------------
    def cross_shard_ami(self, class_id: int, *, mesh=None) -> int:
        """Global AMI of a chunk-split class.

        Stacks each shard's object matrix over the class's full build-
        time property universe; with a ``mesh`` (``dist.mesh.make_mesh``)
        the distinct-row count runs through the ``ami_bucketed``
        hash-bucket exchange on the mesh's devices (every signature
        crosses shards exactly once -- counted in ``traffic``), otherwise
        an exact host count.
        """
        cid = int(class_id)
        props = np.asarray(self.plan.class_props.get(cid, ()), np.int32)
        if props.shape[0] == 0:
            return 0
        mats = []
        for snap in self._snaps:
            fg = snap.fgraph
            st = fg.store if not fg.tables else fg.expand()
            ents, mat = st.object_matrix(cid, props)
            if ents.shape[0]:
                mats.append(mat)
        if not mats:
            return 0
        stack = np.ascontiguousarray(
            np.concatenate(mats, axis=0).astype(np.int32))
        if mesh is None:
            return int(np.unique(stack, axis=0).shape[0])
        from ..core.distributed import ami_bucketed, dp_axes_of, pad_rows
        n_dev = 1
        for s in mesh.devices.shape:
            n_dev *= int(s)
        padded, n = pad_rows(stack, max(n_dev, 1))
        valid = np.arange(padded.shape[0]) < n
        self.traffic["detect_bytes"] += int(stack.shape[0] * 8)
        self.traffic["collective_calls"] += 1
        return int(ami_bucketed(padded, valid, mesh,
                                dp_axes=dp_axes_of(mesh)))

    # -- losslessness / accounting -----------------------------------------
    def expand_union(self) -> TripleStore:
        """Semantic union of every shard's expansion -- the original
        graph, independent of the partition and of what each shard
        factorized (the digest-parity anchor)."""
        parts = [s.fgraph.expand().spo for s in self._snaps]
        return TripleStore.from_ids(self.dict,
                                    np.concatenate(parts, axis=0))

    def digest(self) -> str:
        """Same contract as ``GraphSnapshot.digest()``: sha1 of the
        canonical expanded rows, so sharded == unsharded is one string
        comparison."""
        return hashlib.sha1(np.ascontiguousarray(
            self.expand_union().spo).tobytes()).hexdigest()[:16]

    @property
    def n_triples(self) -> int:
        """Stored rows across shards (post-detection: compact form)."""
        return sum(s.fgraph.n_triples for s in self._snaps)

    def shard_nbytes(self) -> list[int]:
        """Resident substrate bytes per shard: triples + index + the
        shard-local molecule tables (the shared dictionary is excluded
        -- it is the one replicated structure)."""
        out = []
        for snap in self._snaps:
            fg = snap.fgraph
            b = int(fg.store.substrate_nbytes(include_dict=False))
            for t in fg.tables.values():
                b += int(t.surrogates.nbytes) + int(t.objects.nbytes)
            out.append(b)
        return out


# ---------------------------------------------------------------------------
# fan-out query engine
# ---------------------------------------------------------------------------

class ShardedQueryEngine:
    """Star/BGP evaluation against shard-resident molecule tables;
    only binding sets cross shards.

    Class-constrained stars route to the shards holding the class
    (typed subjects are uniquely owned, so per-shard answers
    concatenate).  Classless stars merge per-arm ``(s, v)`` pair sets
    at the coordinator.  BGP stars evaluate to concrete per-shard
    relations, concatenate, and join here -- molecule tables and member
    sets never leave their shard.  Each shard's engine runs
    ``backend="device"`` matches on ``device`` (default ``"cuda"``).
    """

    def __init__(self, sharded: ShardedFactorizedGraph, *,
                 device="cuda") -> None:
        from ..query.batch import QueryEngine
        self.sharded = sharded
        self.device = device
        self.engines = [QueryEngine(s.fgraph, device=device, epoch=s.epoch)
                        for s in sharded.snapshots]

    def rebind(self) -> None:
        """Follow a swap: rebind every per-shard engine to its shard's
        live snapshot (old-epoch device buffers evict per engine
        policy)."""
        for eng, snap in zip(self.engines, self.sharded.snapshots):
            eng.rebind(snap.fgraph, snap.epoch)

    # -- star queries ------------------------------------------------------
    def _route(self, q) -> tuple[int, ...]:
        if q.class_id is None:
            return tuple(range(self.sharded.n_shards))
        return self.sharded.plan.shards_for_class(int(q.class_id))

    def _merge(self, q, parts: list):
        from ..query.star import Bindings
        vp = tuple(int(p) for p in q.var_props)
        parts = [p for p in parts if p is not None]
        if not parts:
            return Bindings(subjects=np.empty((0,), np.int64),
                            var_props=vp,
                            var_objects=np.empty((0, len(vp)), np.int64))
        subs = np.concatenate(
            [np.asarray(p.subjects, np.int64) for p in parts])
        vo = np.concatenate(
            [np.asarray(p.var_objects, np.int64).reshape(
                np.asarray(p.subjects).shape[0], len(vp))
             for p in parts])
        self.sharded.traffic["query_bytes"] += \
            int(subs.nbytes) + int(vo.nbytes)
        return Bindings(subjects=subs, var_props=vp, var_objects=vo)

    def query(self, q, strategy: str = "factorized"):
        if q.class_id is None:
            return self._query_classless(q)
        parts = [self.engines[sid].query(q, strategy)
                 for sid in self._route(q)]
        return self._merge(q, parts)

    def _query_classless(self, q):
        """Coordinator-side per-arm merge: an untyped subject's rows may
        spread over predicate shards, so ground-arm subject sets union
        per arm and var-arm pairs union per arm before the join."""
        from ..query.star import (_arm_pairs, _arm_subject_set,
                                      _intersect, _join_vars)
        cand = None
        for p, o in q.ground_arms:
            subs = np.unique(np.concatenate(
                [_arm_subject_set(eng.fgraph, p, o)
                 for eng in self.engines]) if self.engines
                else np.empty((0,), np.int64))
            self.sharded.traffic["query_bytes"] += int(subs.nbytes)
            cand = _intersect(cand, subs)

        def pairs_of(p, c):
            ss, vv = [], []
            for eng in self.engines:
                s, v = _arm_pairs(eng.fgraph, p, c)
                ss.append(np.asarray(s, np.int64))
                vv.append(np.asarray(v, np.int64))
            s = np.concatenate(ss)
            v = np.concatenate(vv)
            self.sharded.traffic["query_bytes"] += \
                int(s.nbytes) + int(v.nbytes)
            pairs = np.unique(np.stack([s, v], axis=1), axis=0)
            return pairs[:, 0], pairs[:, 1]

        var_props = q.var_props
        if cand is None:
            if not var_props:
                raise ValueError(
                    "star query needs a class or at least one arm")
            s0, _ = pairs_of(var_props[0], None)
            cand = np.unique(s0)
        return _join_vars(cand, var_props, pairs_of)

    def query_batch(self, queries, strategy: str = "factorized",
                    backend: str = "host") -> list:
        """Per-shard grouped fan-out: each shard sees one batched call
        (device-eligible queries keep the one-lowering-per-chunk path
        of the shard's own engine)."""
        queries = list(queries)
        out: list = [None] * len(queries)
        per_shard: dict[int, list[int]] = {}
        partials: dict[int, list] = {}
        for i, q in enumerate(queries):
            if q.class_id is None:
                out[i] = self._query_classless(q)
                continue
            for sid in self._route(q):
                per_shard.setdefault(sid, []).append(i)
        for sid, idxs in per_shard.items():
            res = self.engines[sid].query_batch(
                [queries[i] for i in idxs], strategy=strategy,
                backend=backend)
            for i, b in zip(idxs, res):
                partials.setdefault(i, []).append(b)
        for i, q in enumerate(queries):
            if out[i] is None:
                out[i] = self._merge(q, partials.get(i, []))
        return out

    # -- BGP ---------------------------------------------------------------
    def query_bgp(self, q, strategy: str = "auto",
                  backend: str = "host"):
        """Evaluate each star shard-local (concrete relations), ship
        only the binding sets, and join at the coordinator."""
        from ..query.bgp.algebra import BGPBindings, BGPQuery
        rels: list[BGPBindings] = []
        for star in q.stars:
            fs = tuple(f for f in q.filters if f.var in star.variables)
            if star.class_id is None:
                rels.append(self._classless_star_bindings(star, fs))
                continue
            sub_q = BGPQuery(stars=(star,), filters=fs)
            parts = []
            for sid in self.sharded.plan.shards_for_class(
                    int(star.class_id)):
                b = self.engines[sid].query_bgp(
                    sub_q, strategy=strategy, backend=backend)
                if b.n_rows:
                    parts.append(b)
            cols = sub_q.variables
            if parts:
                rows = np.concatenate(
                    [p.rows[:, [p.columns.index(v) for v in cols]]
                     for p in parts])
            else:
                rows = np.empty((0, len(cols)), np.int64)
            self.sharded.traffic["query_bytes"] += int(rows.nbytes)
            rels.append(BGPBindings(columns=cols, rows=rows))
        out = rels[0]
        for rel in rels[1:]:
            out = _join_bindings(out, rel)
        cols = q.variables
        rows = out.rows[:, [out.columns.index(v) for v in cols]]
        return BGPBindings(columns=cols, rows=rows)

    def _classless_star_bindings(self, star, filters):
        from ..query.bgp.algebra import BGPBindings
        from ..query.star import StarQuery
        sq = StarQuery(arms=tuple(
            (p, None if isinstance(o, str) else int(o))
            for p, o in star.arms), class_id=None)
        b = self._query_classless(sq)
        cols = (star.subject,) + tuple(o for _, o in star.var_arms)
        rows = b.rows()
        out = BGPBindings(columns=cols, rows=rows)
        for f in filters:
            keep = f.apply(out.column(f.var))
            out = BGPBindings(columns=out.columns, rows=out.rows[keep])
        return out


def _join_bindings(a, b):
    """Natural join of two concrete binding relations (coordinator
    side: both inputs are already materialized per-shard unions)."""
    from ..query.bgp.algebra import BGPBindings
    shared = [v for v in a.columns if v in b.columns]
    extra = [v for v in b.columns if v not in a.columns]
    cols = tuple(a.columns) + tuple(extra)
    if not shared:
        ra = np.repeat(np.arange(a.n_rows), b.n_rows)
        rb = np.tile(np.arange(b.n_rows), a.n_rows)
    else:
        ka = a.rows[:, [a.columns.index(v) for v in shared]]
        kb = b.rows[:, [b.columns.index(v) for v in shared]]
        allk = np.concatenate([ka, kb], axis=0)
        _, inv = np.unique(allk, axis=0, return_inverse=True)
        ia, ib = inv[:ka.shape[0]], inv[ka.shape[0]:]
        order = np.argsort(ib, kind="stable")
        ib_s = ib[order]
        lo = np.searchsorted(ib_s, ia, side="left")
        hi = np.searchsorted(ib_s, ia, side="right")
        counts = hi - lo
        ra = np.repeat(np.arange(a.n_rows), counts)
        rb = order[csr_take(lo, counts)]
    if extra:
        rows = np.concatenate(
            [a.rows[ra],
             b.rows[rb][:, [b.columns.index(v) for v in extra]]],
            axis=1)
    else:
        rows = a.rows[ra]
    return BGPBindings(columns=cols, rows=rows)


__all__ = ["ShardPlan", "ShardedFactorizedGraph", "ShardedQueryEngine"]
