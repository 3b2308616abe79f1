"""Immutable versioned snapshots plus the planner that builds them.

* :class:`GraphSnapshot` -- an immutable, epoch-versioned view of the
  compact form: one :class:`~repro_torch.core.fgraph.FactorizedGraph`
  (which carries its own ``GraphIndex`` and instanceOf CSR) plus an
  ``epoch``.  Snapshots are never mutated; every change produces a
  *successor* snapshot (``epoch + 1``) and the owner swaps a single
  reference, so a reader holding the old snapshot keeps a consistent
  world view for as long as it wants.
* :class:`CompactionPlanner` -- the compaction brain: ``plan`` ranks
  classes by predicted savings through the configured detector and
  backend, folding an entity typed twice once, ``execute`` factorizes
  a plan (Algorithm 3) into a fresh snapshot, ``run`` does both;
  ``apply_update``/``apply_delete`` absorb edits as build-new-snapshot
  transforms, and ``redetect`` re-detects
  and re-factorizes only the drifted classes (their sweeps run on the
  configured backend: the hand kernels on ``device``), while every
  clean class's molecule table and surrogate triples pass through.

``repro_torch.api.Compactor`` is a thin facade over one snapshot;
``repro_torch.online`` drives the same planner from its write-ahead
ingest queue.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Iterable, Sequence

import numpy as np

from .. import obs
from ..core import sweep as core_sweep
from ..core.factorize import (FactorizationResult, apply_molecule_map,
                              factorize_classes)
from ..core.fgraph import DeleteStats, FactorizedGraph, MoleculeTable
from ..core.gfsp import FSPResult
from ..core.index import GraphIndex, in_sorted
from ..core.star import folded_edges, row_groups
from ..core.triples import TripleStore
from .backends import ExecutionBackend, get_backend
from .detectors import Detector, get_detector


# ---------------------------------------------------------------------------
# plan / report dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClassPlan:
    """One planned (class, SP) factorization with its predicted payoff.

    The predictions are filled by the auto-planner; explicit plans carry
    ``None`` (the caller already decided, so no evaluation is spent).
    """

    class_id: int
    props: tuple[int, ...]
    predicted_edges: int | None = None   # #Edges(SP, C, G)
    # #Edges(emptyset): the class's rows over S, Σ n_p (AM * |S| under
    # Def. 4.8)
    baseline_edges: int | None = None
    detection: FSPResult | None = None

    @property
    def predicted_savings(self) -> int | None:
        if self.predicted_edges is None or self.baseline_edges is None:
            return None
        return self.baseline_edges - self.predicted_edges

    @property
    def pct_predicted_savings(self) -> float:
        savings = self.predicted_savings
        if not self.baseline_edges or savings is None:
            return 0.0
        return 100.0 * savings / self.baseline_edges


@dataclasses.dataclass
class CompactionPlan:
    """Ranked multi-class factorization plan (highest predicted savings
    first for auto-plans; given order for explicit plans)."""

    entries: list[ClassPlan]
    detector: str = "explicit"
    backend: str = "host"

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __bool__(self) -> bool:
        return bool(self.entries)

    @classmethod
    def explicit(cls, pairs: Sequence[tuple[int, Sequence[int]]]
                 ) -> "CompactionPlan":
        """Plan from caller-chosen (class_id, props) pairs, applied in the
        given order (no ranking, no savings filter, no detection cost --
        predictions stay ``None``)."""
        entries = [ClassPlan(class_id=int(cid),
                             props=tuple(sorted(int(p) for p in props)))
                   for cid, props in pairs]
        return cls(entries=entries, detector="explicit", backend="host")


@dataclasses.dataclass
class CompactionReport:
    """Outcome of one transactional multi-class compaction."""

    graph: TripleStore
    plan: CompactionPlan
    factorizations: list[FactorizationResult]
    n_triples_before: int
    n_triples_after: int
    exec_time_ms: float
    fgraph: FactorizedGraph | None = None   # the structured G' (queryable)

    @property
    def pct_savings_triples(self) -> float:
        if self.n_triples_before == 0:
            return 0.0
        return 100.0 * (self.n_triples_before - self.n_triples_after) \
            / self.n_triples_before

    @property
    def detections(self) -> dict[int, FSPResult]:
        return {e.class_id: e.detection for e in self.plan
                if e.detection is not None}

    def factorization_for(self, class_id: int) -> FactorizationResult:
        for f in self.factorizations:
            if f.class_id == class_id:
                return f
        raise KeyError(class_id)


@dataclasses.dataclass
class UpdateReport:
    """Outcome of one incremental update batch."""

    graph: TripleStore
    n_new_triples: int
    n_entities_absorbed: int
    n_new_surrogates: int
    n_surrogates_reused: int
    exec_time_ms: float
    # per-class deltas for drift tracking: class id -> {"absorbed",
    # "new_surrogates", "reused"}; classes only *touched* (a type row
    # landed but nothing absorbed -- incomplete molecules, brand-new
    # classes) appear in ``touched_classes`` with no delta entry
    per_class: dict[int, dict[str, int]] = dataclasses.field(
        default_factory=dict)
    touched_classes: tuple[int, ...] = ()


@dataclasses.dataclass
class DeleteReport:
    """Outcome of one transactional delete batch."""

    graph: TripleStore
    stats: DeleteStats
    exec_time_ms: float


@dataclasses.dataclass
class RedetectReport:
    """Outcome of one targeted (dirty-classes-only) re-detection pass."""

    considered: tuple[int, ...]      # classes re-evaluated
    refactorized: tuple[int, ...]    # classes the plan kept (payoff >= min)
    plan: CompactionPlan
    exec_time_ms: float
    epoch: int                       # epoch of the snapshot it produced
    descents: int = 0                # EXEC_STATS delta: sweep work spent
    lowerings: int = 0
    per_class_savings: dict[int, int] = dataclasses.field(
        default_factory=dict)       # class id -> predicted Def. 4.8 savings
    rejected: bool = False           # realized-edges guard kept the old form
    edges_before: int = 0            # snapshot triple count going in
    edges_after: int = 0             # ... and of the snapshot returned


# ---------------------------------------------------------------------------
# the snapshot
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class GraphSnapshot:
    """Immutable, versioned view of the compact form.

    Holds one :class:`FactorizedGraph` (tables + instanceOf CSR + the
    store's ``GraphIndex``) and an ``epoch``.  All mutation in this
    codebase is build-new-snapshot-then-swap: a reader that grabbed a
    snapshot can never observe torn state (tables from one version, CSR
    from another), because nothing it references is ever written again.
    """

    fgraph: FactorizedGraph
    epoch: int = 0
    # one-slot memo for ``digest()`` -- a mutable cell so the frozen
    # dataclass can fill it lazily; a swap creates a NEW snapshot object,
    # so invalidation is automatic (never carried across epochs)
    _digest_cache: list = dataclasses.field(
        default_factory=list, init=False, repr=False, compare=False)

    @property
    def store(self) -> TripleStore:
        return self.fgraph.store

    @property
    def index(self) -> GraphIndex:
        return self.fgraph.store.index

    @property
    def n_triples(self) -> int:
        return self.fgraph.n_triples

    def next(self, fgraph: FactorizedGraph) -> "GraphSnapshot":
        """Successor snapshot: new factorized graph, epoch + 1."""
        return GraphSnapshot(fgraph=fgraph, epoch=self.epoch + 1)

    def digest(self) -> str:
        """sha1 of the *semantic* graph (``expand()``, canonical row
        order) -- two snapshots with equal digests represent the same RDF
        graph regardless of how it is factorized.  Cached per snapshot:
        the snapshot is immutable, so the first expansion's hash stays
        valid for its whole lifetime (the online soak's parity checks
        call this in a loop; at 1M triples re-expanding would dominate
        wall clock)."""
        if not self._digest_cache:
            self._digest_cache.append(hashlib.sha1(
                np.ascontiguousarray(self.fgraph.expand().spo).tobytes()
            ).hexdigest()[:16])
        return self._digest_cache[0]

    def to_state(self) -> tuple[dict[str, np.ndarray], dict]:
        """Decompose into (named arrays, JSON-safe meta) for durable
        checkpoints (``repro_torch.online.recovery``).

        The dictionary is deliberately NOT here -- it is shared,
        append-only state owned by the service, checkpointed as a term-
        list prefix alongside.  The instanceOf CSR, surrogate locator
        and ``GraphIndex`` are all rebuilt from ``spo`` + tables by the
        :class:`FactorizedGraph` constructor, so they need no bytes on
        disk.  Everything referenced is immutable, so serialization may
        run on a background thread while the service keeps swapping."""
        fg = self.fgraph
        arrays: dict[str, np.ndarray] = {"spo": fg.store.spo}
        meta = {"epoch": int(self.epoch),
                "payoff_min_support": int(fg.payoff_min_support),
                "tables": []}
        for cid in sorted(fg.tables):
            t = fg.tables[cid]
            arrays[f"table_{cid}_surrogates"] = t.surrogates
            arrays[f"table_{cid}_objects"] = t.objects
            meta["tables"].append({"class_id": int(cid),
                                   "props": [int(p) for p in t.props],
                                   "next_ordinal": int(t.next_ordinal)})
        return arrays, meta

    @classmethod
    def from_state(cls, dictionary, arrays: dict[str, np.ndarray],
                   meta: dict) -> "GraphSnapshot":
        """Inverse of :meth:`to_state` over a restored dictionary."""
        store = TripleStore.from_ids(dictionary, arrays["spo"],
                                     presorted=True)
        tables = {}
        for ent in meta["tables"]:
            cid = int(ent["class_id"])
            tables[cid] = MoleculeTable(
                class_id=cid, props=tuple(ent["props"]),
                surrogates=arrays[f"table_{cid}_surrogates"],
                objects=arrays[f"table_{cid}_objects"],
                next_ordinal=int(ent["next_ordinal"]), presorted=True)
        fg = FactorizedGraph(
            store, tables,
            payoff_min_support=int(meta["payoff_min_support"]))
        return cls(fgraph=fg, epoch=int(meta["epoch"]))

    def __repr__(self) -> str:  # pragma: no cover
        return (f"GraphSnapshot(epoch={self.epoch}, "
                f"n_triples={self.n_triples}, "
                f"classes={len(self.fgraph.tables)})")


def _merge_delete_stats(acc: DeleteStats, st: DeleteStats) -> None:
    """Field-wise accumulate ``st`` into ``acc`` (ints add, the
    ``per_class`` dicts merge key-wise)."""
    for f in dataclasses.fields(st):
        if f.name == "per_class":
            for cid, deltas in st.per_class.items():
                d = acc.per_class.setdefault(cid, {})
                for k, v in deltas.items():
                    d[k] = d.get(k, 0) + v
        else:
            setattr(acc, f.name,
                    getattr(acc, f.name) + getattr(st, f.name))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

class CompactionPlanner:
    """Pure detect/plan/factorize/update/delete/redetect over snapshots.

    Every method either reads a plain store (``plan``/``execute``) or a
    :class:`GraphSnapshot` and -- when it changes anything -- returns a
    *new* snapshot, leaving its input untouched.  The planner holds only
    configuration (detector, backend, thresholds); all graph state lives
    in the snapshots, which is what makes the owner's commit an atomic
    reference swap.
    """

    def __init__(self, detector: str | Detector = "gfsp",
                 backend: str | ExecutionBackend = "host", *,
                 min_predicted_savings: int = 1,
                 surrogate_prefix: str = "repro:sg",
                 detector_opts: dict | None = None,
                 backend_opts: dict | None = None) -> None:
        self.detector = get_detector(detector, **(detector_opts or {}))
        self.backend = get_backend(backend, **(backend_opts or {}))
        self.min_predicted_savings = min_predicted_savings
        self.surrogate_prefix = surrogate_prefix

    # -- detection ---------------------------------------------------------
    def detect(self, store: TripleStore, class_id: int,
               props: Sequence[int] | None = None) -> FSPResult:
        """Run the configured detector on one class."""
        cid = int(class_id)
        with obs.span("detect", class_id=cid) as sp:
            res = self.detector.detect(store, cid, backend=self.backend,
                                       props=props)
            sp.set(am=int(res.am), n_s=len(
                props if props is not None else store.class_properties(cid)))
        return res

    def _shard_planner(self, sid: int) -> "CompactionPlanner":
        """Per-shard clone: same detector/backend instances, a shard-
        suffixed surrogate prefix so shards minting into the shared
        dictionary can never collide on a surrogate name."""
        return CompactionPlanner(
            self.detector, self.backend,
            min_predicted_savings=self.min_predicted_savings,
            surrogate_prefix=f"{self.surrogate_prefix}/s{int(sid)}")

    # -- planning ----------------------------------------------------------
    def plan(self, store: TripleStore | None = None,
             classes: Iterable[int] | None = None, *,
             stream: bool = False,
             sharded_graph=None) -> CompactionPlan | dict:
        """Rank all (or the given) classes by predicted #Edges savings.

        With ``sharded_graph=`` (a
        :class:`~repro_torch.dist.graph.ShardedFactorizedGraph`) the
        ranking runs shard-local over each shard's semantic sub-store and
        a ``{shard_id: CompactionPlan}`` dict comes back -- the detection
        itself never leaves the shard.

        ``stream=True`` releases the store's transient decode caches
        between classes (compressed tier: resident CSR partitions,
        per-class entity vectors, sorted-object caches), so detection
        over an out-of-core-scale graph holds at most one class's
        working set uncompressed at a time -- peak host memory is bounded
        by the largest class bucket, not the graph."""
        with obs.span("plan"):
            return self._plan(store, classes, stream=stream,
                              sharded_graph=sharded_graph)

    def _plan(self, store, classes, *, stream, sharded_graph):
        if sharded_graph is not None:
            out = {}
            for sid, snap in enumerate(sharded_graph.snapshots):
                sub = (snap.fgraph.store if not snap.fgraph.tables
                       else snap.fgraph.expand())
                out[sid] = self._shard_planner(sid).plan(
                    sub, classes, stream=stream)
            return out
        if store is None:
            raise ValueError("plan() needs a store or a sharded_graph")
        cids = ([int(c) for c in classes] if classes is not None
                else [int(c) for c in store.classes()])
        release = getattr(store, "release_transients", None) \
            if stream else None
        entries = []
        for cid in cids:
            stats = store.class_stats(cid)
            n_s = int(stats.properties.shape[0])
            am = stats.n_instances
            if n_s < 2 or am == 0:
                continue                      # nothing star-shaped to share
            res = self.detect(store, cid)
            if len(res.props) < 2:
                if release is not None:
                    release()
                continue
            baseline = res.baseline_edges
            entry = ClassPlan(class_id=cid, props=tuple(sorted(res.props)),
                              predicted_edges=res.edges,
                              baseline_edges=am * n_s if baseline is None
                              else baseline, detection=res)
            if entry.predicted_savings >= self.min_predicted_savings:
                entries.append(entry)
            if release is not None:
                release()
        entries.sort(key=lambda e: -e.predicted_savings)
        return CompactionPlan(entries=self._fold_once(store, entries),
                              detector=self.detector.name,
                              backend=self.backend.name)

    def _fold_once(self, store: TripleStore, entries: list[ClassPlan]
                   ) -> list[ClassPlan]:
        """The ranked entries as they factorize, one after the other: an
        entity typed twice is folded once.  An earlier entry moves its
        folded entities' arms of its SP to surrogates, so a later entry
        whose SP shares one of those properties no longer finds them.
        Such an entry is rescored on the entities left to it (AMI,
        #Edges and the predictions, in the plan and its detection; the
        baseline and the search's counts stay as detected) and kept only
        where it still saves ``min_predicted_savings``.

        The folded sets come from the detections' star groups, so the
        pass extracts nothing; it compares them only where two classes
        share a property of their SPs and an entity.  Entries scored by
        Def. 4.8 (the ``complete`` objective) pass as detected."""
        with obs.span("fold", entries=len(entries)) as sp:
            out: list[ClassPlan] = []
            folded: list[list] = []     # [entry, its folded ents or None]
            rescored = 0

            def members(entry):
                ents = [g[0] for g in entry.detection.fsp]
                return np.sort(np.concatenate(ents)) if ents else \
                    np.empty((0,), np.int32)

            for e in entries:
                if e.detection is None or \
                        e.detection.baseline_edges is None:
                    out.append(e)
                    continue
                ents = store.entities_of_class(e.class_id)
                earlier = [f for f in folded
                           if set(f[0].props) & set(e.props)
                           and in_sorted(ents, store.entities_of_class(
                               f[0].class_id)).any()]
                if earlier:
                    for f in earlier:
                        if f[1] is None:
                            f[1] = members(f[0])
                    e = self._rescore(e, np.unique(np.concatenate(
                        [f[1] for f in earlier])))
                    rescored += 1
                    if e is None:
                        continue
                out.append(e)
                folded.append([e, None])
            sp.set(rescored=rescored, dropped=len(entries) - len(out))
        return out

    def _rescore(self, entry: ClassPlan, gone: np.ndarray
                 ) -> ClassPlan | None:
        """``entry`` scored on its folded entities outside the sorted
        ``gone``; None where it no longer saves enough."""
        det = entry.detection
        groups = det.fsp
        sizes = np.array([g[0].shape[0] for g in groups], np.int64)
        ents = np.concatenate([g[0] for g in groups]) if groups else \
            np.empty((0,), np.int32)
        left = ~in_sorted(ents, gone)
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        per_group = (np.add.reduceat(left.astype(np.int64), bounds[:-1])
                     if groups else sizes)
        a, n_e = int((per_group > 0).sum()), int(left.sum())
        edges = int(folded_edges(a, n_e, len(entry.props),
                                 entry.baseline_edges))
        if entry.baseline_edges - edges < self.min_predicted_savings:
            return None
        fsp = [(g[0][left[lo:hi]], g[1])
               for g, lo, hi, m in zip(groups, bounds[:-1], bounds[1:],
                                       per_group) if m]
        det = dataclasses.replace(det, edges=edges, ami=a, fsp=fsp)
        return dataclasses.replace(entry, predicted_edges=edges,
                                   detection=det)

    # -- execution ---------------------------------------------------------
    def execute(self, store: TripleStore, plan: CompactionPlan, *,
                epoch: int = 0) -> tuple[GraphSnapshot, CompactionReport]:
        """Factorize every planned class transactionally into a fresh
        snapshot.  The input store is never mutated."""
        t0 = time.perf_counter()
        with obs.span("execute"):
            pairs = [(e.class_id, e.props) for e in plan]
            graph, results = factorize_classes(
                store, pairs, surrogate_prefix=self.surrogate_prefix)
            # star_objects rows are aligned with surrogates and ordered
            # over sorted props -- the molecule tables build with no
            # rescan of G'
            fg = FactorizedGraph.from_compaction(graph, results)
        snap = GraphSnapshot(fgraph=fg, epoch=epoch)
        report = CompactionReport(
            graph=graph, plan=plan, factorizations=results,
            n_triples_before=store.n_triples, n_triples_after=graph.n_triples,
            exec_time_ms=(time.perf_counter() - t0) * 1e3,
            fgraph=fg)
        return snap, report

    def run(self, store: TripleStore,
            classes: Iterable[int] | None = None, *,
            stream: bool = False
            ) -> tuple[GraphSnapshot, CompactionReport]:
        """plan + execute in one call (the common entry point)."""
        return self.execute(store, self.plan(store, classes, stream=stream))


    # -- incremental update ------------------------------------------------
    def apply_update(self, snapshot: GraphSnapshot,
                     new_triples) -> tuple[GraphSnapshot, UpdateReport]:
        """Absorb streaming inserts into a new snapshot.

        ``new_triples``: an (n, 3) id array (shared dictionary) or an
        iterable of (subject, property, object) term triples.  New
        entities of factorized classes whose object tuple matches an
        existing star pattern are linked to its surrogate; novel tuples
        mint fresh surrogates (continuing per-class ordinals); incomplete
        molecules and unplanned classes stay raw.  No full recomputation,
        no mutation of ``snapshot``.
        """
        fg = snapshot.fgraph
        t0 = time.perf_counter()
        g = fg.store
        if isinstance(new_triples, np.ndarray):
            rows = np.asarray(new_triples, np.int32).reshape(-1, 3)
        else:
            trips = list(new_triples)
            if trips:
                flat = [t for spo in trips for t in spo]
                rows = g.dict.ids(flat).reshape(-1, 3)
            else:
                rows = np.empty((0, 3), np.int32)
        # merge-on-append: the (usually small) batch merges into the
        # sorted triple array and the live GraphIndex in O(n + m log n);
        # the factorized graph is never re-sorted or re-indexed wholesale.
        # A compressed-tier store migrates to the plain tier here (one
        # decode) instead of repacking per batch -- the online service's
        # background recompression re-packs it off the hot path.
        if getattr(g, "is_compressed", False):
            combined = TripleStore.from_ids(g.dict, g.spo, presorted=True)
        else:
            combined = g.copy()
        combined.add_ids(rows)
        n_absorbed = n_new_sg = n_reused = 0
        per_class: dict[int, dict[str, int]] = {}
        # classes are processed sequentially against the running graph so
        # overlapping-class entities keep the same semantics as a full
        # factorize_classes pass; the surrogate id set is loop-invariant
        # (ids minted below are never entities of another planned class)
        sg_arr = fg.surrogate_ids.astype(np.int64)
        new_tables: dict[int, MoleculeTable] = {}
        for cid, table in fg.tables.items():
            sig = table.sig            # read-only probe; commit-at-end
            next_ordinal = table.next_ordinal
            props_arr = np.asarray(table.props, np.int32)
            new_tables[cid] = table
            ents, objmat = combined.object_matrix(cid, props_arr)
            if ents.size == 0:
                continue
            raw = ~in_sorted(ents, sg_arr)    # never re-factorize surrogates
            if not raw.any():
                continue
            r_ents, r_mat = ents[raw], objmat[raw]
            inv, counts, rep = row_groups(r_mat)
            sg_of_group = np.empty((counts.shape[0],), np.int64)
            fresh: list[tuple[int, tuple[int, ...]]] = []
            for gi in range(counts.shape[0]):
                key = tuple(int(x) for x in r_mat[rep[gi]])
                sg = sig.get(key)
                if sg is None:
                    fresh.append((gi, key))
                else:
                    sg_of_group[gi] = sg
            if fresh:
                cname = combined.dict.term(cid)
                names = [f"{self.surrogate_prefix}/{cname}/"
                         f"{next_ordinal + j}" for j in range(len(fresh))]
                new_ids = combined.dict.ids(names)
                next_ordinal += len(fresh)
                fresh_rows = np.asarray([key for _, key in fresh], np.int32)
                for (gi, _), sid in zip(fresh, new_ids.tolist()):
                    sg_of_group[gi] = sid
                # amortized append: fresh ids are minted in ascending
                # order past every existing surrogate, so the hot loop
                # extends the table's capacity buffer instead of paying
                # an O(M) copy per small batch
                new_tables[cid] = table.with_rows(
                    new_ids, fresh_rows, next_ordinal)
            n_new_sg += len(fresh)
            n_reused += int(counts.shape[0]) - len(fresh)
            n_absorbed += int(r_ents.shape[0])
            per_class[int(cid)] = {
                "absorbed": int(r_ents.shape[0]),
                "new_surrogates": len(fresh),
                "reused": int(counts.shape[0]) - len(fresh)}
            # rewrite only the absorbed entities' own rows; the rest of
            # the (possibly huge) factorized graph passes through as a
            # presorted slice and the rewritten rows merge back in.  The
            # live index follows the same remove-then-merge path (a row
            # subset of a sorted index stays sorted), so no class of this
            # loop ever triggers a full O(|G| log |G|) re-index.
            spo = combined.spo
            touched = in_sorted(spo[:, 0], r_ents)
            rewritten = apply_molecule_map(
                spo[touched], r_ents, sg_of_group[inv].astype(np.int32),
                props_arr, cid, combined.TYPE, combined.INSTANCE_OF)
            idx = combined.index
            kept_index = idx.filtered(~in_sorted(idx.rows[:, 0], r_ents))
            combined = TripleStore.from_ids(combined.dict, spo[~touched],
                                            presorted=True)
            combined.add_ids(rewritten)
            combined._index = kept_index.merged(rewritten)
        # classes touched by the batch (for drift tracking): any class a
        # type row landed in, plus every class that absorbed something
        touched_cids = set(per_class)
        if rows.shape[0]:
            type_rows = rows[rows[:, 1] == g.TYPE, 2]
            touched_cids.update(int(c) for c in np.unique(type_rows)
                                if not fg.is_surrogate(
                                    np.asarray([c]))[0])
        new_fg = FactorizedGraph(
            combined, new_tables,
            payoff_min_support=fg.payoff_min_support)
        report = UpdateReport(
            graph=combined, n_new_triples=int(rows.shape[0]),
            n_entities_absorbed=n_absorbed, n_new_surrogates=n_new_sg,
            n_surrogates_reused=n_reused,
            exec_time_ms=(time.perf_counter() - t0) * 1e3,
            per_class=per_class,
            touched_classes=tuple(sorted(touched_cids)))
        return snapshot.next(new_fg), report

    # -- deletes -----------------------------------------------------------
    def apply_delete(self, snapshot: GraphSnapshot, triples=None,
                     entities=None) -> tuple[GraphSnapshot, DeleteReport]:
        """Remove semantic triples and/or entities into a new snapshot.

        ``triples``: an (n, 3) id array or an iterable of term triples;
        ``entities``: an id array or an iterable of entity terms.  Both
        route through :class:`FactorizedGraph` delete support --
        molecule-covered triples dissolve memberships, and molecules
        whose support drops below payoff decompact in place.
        """
        fg = snapshot.fgraph
        t0 = time.perf_counter()
        stats = DeleteStats()
        if triples is not None:
            if isinstance(triples, np.ndarray):
                rows = np.asarray(triples, np.int32).reshape(-1, 3)
            else:
                # lookup, never id(): a term the graph has never seen
                # cannot name an existing triple, and a no-op delete must
                # not grow the shared dictionary as a side effect
                d = fg.store.dict
                rows_list = []
                n_unknown = 0
                for s, p, o in triples:
                    ids3 = (d.lookup(s), d.lookup(p), d.lookup(o))
                    if None in ids3:
                        n_unknown += 1
                        continue
                    rows_list.append(ids3)
                stats.n_requested += n_unknown     # counted, trivially absent
                rows = np.asarray(rows_list, np.int32).reshape(-1, 3)
            fg, st = fg.delete_triples(rows)
            _merge_delete_stats(stats, st)
        if entities is not None:
            if isinstance(entities, np.ndarray):
                ids = np.asarray(entities, np.int64).reshape(-1)
            else:
                d = fg.store.dict
                looked = [d.lookup(e) for e in entities]
                stats.n_requested += sum(1 for x in looked if x is None)
                ids = np.asarray([x for x in looked if x is not None],
                                 np.int64)
            fg, st = fg.delete_entities(ids)
            _merge_delete_stats(stats, st)
        report = DeleteReport(graph=fg.store, stats=stats,
                              exec_time_ms=(time.perf_counter() - t0) * 1e3)
        return snapshot.next(fg), report

    # -- targeted re-detection ---------------------------------------------
    def redetect(self, snapshot: GraphSnapshot | None,
                 class_ids: Iterable[int], *, sharded_graph=None
                 ) -> tuple[GraphSnapshot, RedetectReport] | tuple:
        """Re-detect and re-factorize ONLY the given (drifted) classes.

        With ``sharded_graph=`` the pass runs shard-local (``snapshot``
        is ignored): every shard holding a dirty class builds its own
        successor through a per-shard-prefixed planner, and the whole
        snapshot tuple swaps atomically ONCE at the end -- a reader
        holding the old tuple keeps a consistent world view.  Returns
        ``(sharded_graph, {shard_id: RedetectReport})``.

        The dirty classes are decompacted in place (their members take
        their arms back as raw triples; every clean class's surrogate
        triples and molecule table survive untouched), the detector runs
        per dirty class through the candidate-batched sweep engine, and
        classes whose predicted savings still clear the planner threshold
        re-factorize.  A class whose payoff evaporated stays raw -- the
        paper's Fig. 7 overhead case handled *live*.  Sweep work is
        proportional to the dirty-class set: ``EXEC_STATS`` descent and
        lowering deltas are recorded on the report.

        The pass is guarded on REALIZED edges: under the ``complete``
        objective predicted Def. 4.8 savings are computed on the
        candidate population (complete functional molecules, §4.3), so a
        re-plan can look profitable yet cost more actual triples once
        incomplete entities fall back to raw form (the default, folded
        objective predicts the rows the factorization removes).  If the
        rebuilt graph carries more triples than the
        current one, the pass is rejected -- the old snapshot stays live
        (``report.rejected``), so an online re-detection can only ever
        improve or hold the realized edge count, never regress it.
        """
        if sharded_graph is not None:
            cids = sorted({int(c) for c in class_ids})
            snaps = list(sharded_graph.snapshots)
            reports = {}
            for sid, snap in enumerate(snaps):
                local = [c for c in cids
                         if sid in sharded_graph.plan.shards_for_class(c)
                         or c in snap.fgraph.tables]
                if not local:
                    continue
                new_snap, rep = self._shard_planner(sid).redetect(
                    snap, local)
                snaps[sid] = new_snap
                reports[sid] = rep
            sharded_graph.swap(snaps)     # one atomic tuple store
            return sharded_graph, reports
        t0 = time.perf_counter()
        fg = snapshot.fgraph
        cids = sorted({int(c) for c in class_ids})
        exec_before = dict(core_sweep.EXEC_STATS)
        base = fg.decompact_classes(cids)
        plan = self.plan(base.store, classes=cids)
        pairs = [(e.class_id, e.props) for e in plan]
        graph, results = factorize_classes(
            base.store, pairs, surrogate_prefix=self.surrogate_prefix)
        tables = dict(base.tables)
        for res in results:
            tables[int(res.class_id)] = MoleculeTable(
                class_id=int(res.class_id),
                props=tuple(sorted(int(p) for p in res.props)),
                surrogates=res.surrogates, objects=res.star_objects,
                next_ordinal=int(res.surrogates.shape[0]))
        new_fg = FactorizedGraph(graph, tables,
                                 payoff_min_support=fg.payoff_min_support)
        rejected = new_fg.n_triples > fg.n_triples
        new_snap = snapshot if rejected else snapshot.next(new_fg)
        report = RedetectReport(
            considered=tuple(cids),
            refactorized=() if rejected
            else tuple(int(e.class_id) for e in plan),
            plan=plan,
            exec_time_ms=(time.perf_counter() - t0) * 1e3,
            epoch=new_snap.epoch,
            descents=core_sweep.EXEC_STATS["descents"]
            - exec_before["descents"],
            lowerings=core_sweep.EXEC_STATS["lowerings"]
            - exec_before["lowerings"],
            per_class_savings={int(e.class_id): int(e.predicted_savings)
                               for e in plan
                               if e.predicted_savings is not None},
            rejected=rejected,
            edges_before=fg.n_triples,
            edges_after=new_snap.fgraph.n_triples)
        return new_snap, report


__all__ = ["ClassPlan", "CompactionPlan", "CompactionReport",
           "UpdateReport", "DeleteReport", "RedetectReport",
           "GraphSnapshot", "CompactionPlanner"]
