"""Batched LM serving with factorized shared prefixes.

The port's copy of the LM ``Engine`` of ``repro/serving/engine.py``.
Flow per admission wave:

  1. collect queued requests into one batch (left-padded to one length);
  2. ``plan_prefix_sharing`` (the paper's #Edges-in-bytes objective)
     decides the shared depth d*;
  3. prefill each distinct MOLECULE once, gather its cache into the
     per-request slots along the batch axis ("instanceOf" expansion),
     and decode-extend the per-request suffixes;
  4. greedy decode steps over the whole batch.

Two faults of the JAX engine are not carried over: the molecule cache
is gathered along axis 0, the batch axis of every per-layer cache
tensor (the JAX engine gathers axis 1, the batch axis only of
layer-stacked caches), and the last prompt token is decoded once --
the shared path's next token comes from its last decode-extend step,
or from the molecule prefill when the suffix is empty (the JAX engine
decodes it a second time, which advances an RG-LRU state twice).

Policies (``PREFIX_POLICIES``): ``auto`` plans and honors a positive
sharing decision, ``flat`` serves plain batched prefill, ``measure``
plans (``Engine.last_plan``) but serves flat.

The graph-query endpoint (:class:`GraphQueryService`, the port of the
JAX package's) answers term-level star and multi-star BGP requests on a
compacted graph, one snapshot per wave.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..kernels.ops import resolve_device
from ..registry import Registry
from ..train.serve_step import make_decode_step, make_prefill_step
from .prefix_factorization import plan_prefix_sharing


@dataclasses.dataclass(frozen=True)
class PrefixPolicy:
    """Named KV-prefix compaction strategy: ``plan`` runs the planner,
    ``share`` honors a positive sharing decision."""

    name: str
    plan: bool
    share: bool


PREFIX_POLICIES = Registry("prefix policy")
PREFIX_POLICIES.register("auto", PrefixPolicy("auto", plan=True, share=True))
PREFIX_POLICIES.register("flat", PrefixPolicy("flat", plan=False,
                                              share=False))
PREFIX_POLICIES.register("measure", PrefixPolicy("measure", plan=True,
                                                 share=False))


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray               # (L,) prompt
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)


def _gather_batch(cache: list, idx: torch.Tensor) -> list:
    """Rows ``idx`` of every tensor of a per-layer cache (batch axis 0)."""
    return [{blk: {k: t.index_select(0, idx) for k, t in d.items()}
             for blk, d in layer.items()} for layer in cache]


class Engine:
    """Greedy batched serving of an :class:`~repro_torch.models.LM`.

    ``device`` defaults to ``"cuda"`` and raises without a card; the
    model must live there (build it with the same ``device``).
    After :meth:`run`, ``stats`` holds the wall seconds of the prompt
    phase (``prefill_s``; with sharing, ``molecule_prefill_s`` of it is
    the molecules' prefill) and of each decode step (``decode_s``), each
    ending when the device has finished it, and with ``keep_logits`` ``logits`` holds the (steps, B, V)
    float32 logits each generated token was chosen from.
    """

    def __init__(self, model, *, cache_len: int = 512, chunk: int = 64,
                 policy: str | PrefixPolicy = "auto", device="cuda"):
        cfg = model.cfg
        if cfg.encoder_layers or cfg.frontend != "none":
            # the JAX engine prefills these without their frontend_embeds
            # and fails inside the encoder or the stub's projection
            raise ValueError(
                f"{cfg.name} ({cfg.frontend}) needs frontend_embeds, which "
                "Engine requests do not carry: serve it through "
                "train.serve_step.make_prefill_step(model, cache_len=...)"
                "(tokens, frontend_embeds) and make_decode_step")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}; build the LM with the same "
                             "device")
        self.model = model
        self.cfg = model.cfg
        self.cache_len = cache_len
        self.chunk = chunk
        self.policy = (policy if isinstance(policy, PrefixPolicy)
                       else PREFIX_POLICIES.get(policy))
        self._prefill = make_prefill_step(model, cache_len=cache_len)
        self._decode = make_decode_step(model)
        self.queue: list[Request] = []
        self.last_plan = None
        self.stats: dict = {}
        self.logits: torch.Tensor | None = None

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # -- internals -------------------------------------------------------------
    def _kv_bytes_per_token(self) -> float:
        cfg = self.cfg
        per_layer = 2 * cfg.n_kv_heads * cfg.resolved_head_dim \
            * self.model.dtype.itemsize
        return float(per_layer * cfg.n_layers)

    def _plan_prefixes(self, tokens: np.ndarray):
        plan = plan_prefix_sharing(
            tokens, chunk=self.chunk,
            kv_bytes_per_token=self._kv_bytes_per_token())
        self.last_plan = plan
        return plan

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                               device=self.device)

    def _prefill_shared(self, tokens: np.ndarray, plan):
        """(next token, cache, next-token logits) after the whole prompt."""
        if not plan.shares or plan.molecule_tokens.shape[0] == len(tokens):
            return self._prefill(self._tensor(tokens))
        # 1. prefill each molecule once
        t0 = time.perf_counter()
        _, mol_cache, mol_logits = self._prefill(
            self._tensor(plan.molecule_tokens))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["molecule_prefill_s"] = time.perf_counter() - t0
        # 2. expand to instances along the batch axis (the instanceOf edge)
        idx = torch.as_tensor(plan.instance_of, dtype=torch.int64,
                              device=self.device)
        cache = _gather_batch(mol_cache, idx)
        logits = mol_logits.index_select(0, idx)
        nxt = logits.argmax(dim=-1).int()
        # 3. decode-extend the suffixes; the last step's logits are the
        #    next-token logits (no second decode of the last prompt token)
        suffix = self._tensor(tokens[:, plan.suffix_start:])
        b = tokens.shape[0]
        for t in range(suffix.shape[1]):
            pos = torch.full((b, 1), plan.suffix_start + t, dtype=torch.int32,
                             device=self.device)
            nxt, cache, logits = self._decode(suffix[:, t:t + 1], cache, pos)
        return nxt, cache, logits

    # -- main loop ---------------------------------------------------------------
    def run(self, *, max_new: int | None = None,
            keep_logits: bool = False) -> dict[int, list[int]]:
        if not self.queue:
            return {}
        batch, self.queue = self.queue, []
        lens = {r.tokens.shape[0] for r in batch}
        m = max(lens)
        toks = np.stack([np.pad(np.asarray(r.tokens), (m - len(r.tokens), 0))
                         for r in batch])                 # left-pad
        steps = max_new if max_new is not None else max(r.max_new
                                                        for r in batch)
        self.stats = {"decode_s": []}
        t0 = time.perf_counter()
        plan = self._plan_prefixes(toks) if self.policy.plan else None
        if self.policy.share and plan is not None:
            nxt, cache, logits = self._prefill_shared(toks, plan)
        else:
            nxt, cache, logits = self._prefill(self._tensor(toks))
        kept = [logits] if keep_logits else None
        outs = {r.rid: [t] for r, t in zip(batch, nxt.tolist())}
        self.stats["prefill_s"] = time.perf_counter() - t0
        cur = nxt[:, None]
        for t in range(1, steps):
            t1 = time.perf_counter()
            pos = torch.full((len(batch), 1), m + t - 1, dtype=torch.int32,
                             device=self.device)
            cur, cache, logits = self._decode(cur, cache, pos)
            for r, tok in zip(batch, cur.tolist()):
                outs[r.rid].append(tok)
            self.stats["decode_s"].append(time.perf_counter() - t1)
            if keep_logits:
                kept.append(logits)
            cur = cur[:, None]
        self.logits = torch.stack(kept) if keep_logits else None
        for r in batch:
            r.out = outs[r.rid]
        return outs


# -- graph-query endpoint -----------------------------------------------------

@dataclasses.dataclass
class GraphQueryRequest:
    """One star BGP at the term level: ``arms`` are (property term,
    object term or None-for-variable) pairs, plus an optional class."""

    rid: int
    arms: tuple[tuple[str, str | None], ...]
    class_term: str | None = None
    strategy: str = "factorized"     # "factorized" | "raw"


@dataclasses.dataclass
class GraphQueryResponse:
    rid: int
    subjects: list[str]
    var_props: tuple[str, ...]
    var_objects: list[tuple[str, ...]]   # aligned with subjects
    strategy: str
    n_rows: int
    # "ok" | "degraded" (factorized path failed; answered via raw
    # fallback) | "shed" (per-wave deadline exhausted; NOT evaluated)
    status: str = "ok"


@dataclasses.dataclass
class BGPQueryRequest:
    """A multi-star BGP at the term level.  Each star is ``(subject,
    arms, class_term)`` with arms as (property term, object term) pairs;
    any term starting with ``"?"`` is a variable (subjects must be
    variables).  ``filters`` are ``(var, op, value term)`` triples with
    ``op`` one of ``== != < <= > >=``."""

    rid: int
    stars: tuple[tuple[str, tuple[tuple[str, str], ...], str | None], ...]
    filters: tuple[tuple[str, str, str], ...] = ()
    strategy: str = "auto"           # "auto" | "raw" | "factorized"


@dataclasses.dataclass
class BGPQueryResponse:
    rid: int
    variables: tuple[str, ...]       # canonical output column order
    rows: list[tuple[str, ...]]      # decoded bindings, aligned
    strategies: tuple[str, ...]      # planner's per-star choices
    n_rows: int
    status: str = "ok"               # "ok" | "degraded" | "shed"


def _compile_star(req: GraphQueryRequest, d):
    """Term-level star request -> id-level :class:`StarQuery` (``None``
    when any term is unknown to the dictionary: nothing can match it)."""
    from ..query import StarQuery
    cid = None
    if req.class_term is not None:
        cid = d.lookup(req.class_term)
        if cid is None:
            return None
    arms = []
    for p, o in req.arms:
        pid = d.lookup(p)
        if pid is None:
            return None
        if o is None:
            arms.append((pid, None))
        else:
            oid = d.lookup(o)
            if oid is None:
                return None
            arms.append((pid, oid))
    return StarQuery(arms=tuple(arms), class_id=cid)


def _compile_bgp_query(req: BGPQueryRequest, d):
    """Term-level BGP request -> id-level ``BGPQuery`` (``None`` when any
    ground term or filter value is unknown to the dictionary)."""
    from ..query import BGPQuery, Filter, StarPattern
    from ..query.bgp import is_var

    def enc(t):
        return t if is_var(t) else d.lookup(t)

    stars = []
    for subject, arms, class_term in req.stars:
        cid = None
        if class_term is not None:
            cid = d.lookup(class_term)
            if cid is None:
                return None
        enc_arms = []
        for p, o in arms:
            pid, oid = d.lookup(p), enc(o)
            if pid is None or oid is None:
                return None
            enc_arms.append((pid, oid))
        stars.append(StarPattern(subject, tuple(enc_arms), class_id=cid))
    filters = []
    for var, op, value in req.filters:
        vid = d.lookup(value)
        if vid is None:
            return None
        filters.append(Filter(var, op, vid))
    return BGPQuery(stars=tuple(stars), filters=tuple(filters))


class GraphQueryService:
    """Star- and BGP-query endpoint over a compacted graph (the paper's
    "queries get faster on G'" claim, served).

    Wraps a :class:`~repro_torch.query.QueryEngine` with the same
    queue/run shape as the LM :class:`Engine`: requests accumulate via
    :meth:`submit`, and :meth:`run` drains the queue -- class-constrained
    in-SP star queries of one wave ride the batched molecule match when
    ``backend="device"``, everything else evaluates on host.  Terms
    unknown to the dictionary yield empty binding sets.
    :class:`BGPQueryRequest` entries of the same queue route through the
    cost-based BGP engine (``QueryEngine.query_bgp``), deferred stars on
    the same backend.

    ``device`` (default ``"cuda"``) is where ``backend="device"`` runs;
    it is resolved at construction, so without CUDA the constructor
    raises instead of every wave degrading to the host.

    ``source`` is a *snapshot handle*, any of: a bare
    ``FactorizedGraph``; a :class:`~repro_torch.api.GraphSnapshot`; an
    object with a ``.snapshot`` property (``OnlineCompactionService``,
    ``Compactor``) -- the live handle; or a zero-arg callable returning
    any of these.  Each ``run`` wave resolves the handle ONCE and serves
    the whole wave from that immutable snapshot: queries arriving during an
    in-flight recompaction are answered from the old epoch, and the next
    wave picks up the swap.  The engine's device buffers are
    epoch-keyed, so a swap invalidates them without coordination.

    **Graceful degradation** (all counted in ``metrics``, a
    :class:`~repro_torch.online.metrics.MetricsHub`):

    * ``max_pending`` bounds the admission queue -- a full queue sheds
      the submit (``submit`` returns ``False``; ``admission.shed``);
    * ``wave_deadline_s`` budgets one ``run`` wave on ``clock`` (default
      ``time.monotonic``) -- requests the budget cannot reach are
      answered with ``status="shed"`` and empty bindings
      (``wave.deadline_shed``), never dropped;
    * on the host backend, a factorized-path failure mid-wave falls back
      to raw ``expand()`` evaluation for the affected requests
      (``status="degraded"``, ``wave.raw_fallback``) -- answers stay
      correct, only slower.  On the device backend a failure raises: a
      kernel that does not build or launch is never answered quietly on
      the host.
    """

    def __init__(self, source, *, backend: str = "host", device="cuda",
                 max_pending: int | None = None,
                 wave_deadline_s: float | None = None,
                 metrics=None, clock=None):
        from ..online.metrics import MetricsHub
        from ..query import QueryEngine
        self._source = source
        self.backend = backend
        if backend == "device":
            device = resolve_device(device)
        snap = self._resolve()
        self.engine = QueryEngine(snap.fgraph, device=device,
                                  epoch=snap.epoch)
        self.queue: list = []
        self.max_pending = max_pending
        self.wave_deadline_s = wave_deadline_s
        self.metrics = metrics if metrics is not None else MetricsHub()
        self._clock = clock if clock is not None else time.monotonic
        for ch in ("admission.shed", "wave.deadline_shed",
                   "wave.raw_fallback"):
            self.metrics.channel(ch)

    def _resolve(self):
        """Current snapshot from the handle (one atomic read)."""
        from ..api.snapshot import GraphSnapshot
        src = self._source
        if callable(src):
            src = src()
        if isinstance(src, GraphSnapshot):
            return src
        snap = getattr(src, "snapshot", None)
        if snap is not None:
            return snap
        return GraphSnapshot(fgraph=src, epoch=0)   # bare FactorizedGraph

    @property
    def fgraph(self):
        """The fgraph a wave starting now would serve from."""
        return self._resolve().fgraph

    @property
    def epoch(self) -> int:
        return int(self._resolve().epoch)

    def submit(self, req) -> bool:
        """Admit ``req`` into the next wave.  Returns ``False`` (and
        counts ``admission.shed``) when the bounded queue is full."""
        if self.max_pending is not None \
                and len(self.queue) >= self.max_pending:
            self.metrics.observe("admission.shed", 1)
            return False
        self.queue.append(req)
        return True

    def _run_bgp(self, req: BGPQueryRequest, snap) -> BGPQueryResponse:
        q = _compile_bgp_query(req, snap.fgraph.store.dict)
        if q is None:        # unknown term: nothing can match it
            return BGPQueryResponse(req.rid, (), [], (), 0)
        try:
            b, stats = self.engine.query_bgp(
                q, strategy=req.strategy, backend=self.backend,
                return_stats=True)
            status = "ok"
        except Exception:
            if req.strategy == "raw" or self.backend == "device":
                raise            # the fallback itself failed, or the card
            # factorized/auto path failed mid-wave: answer from the
            # raw expansion instead of failing the request (counted)
            self.metrics.observe("wave.raw_fallback", 1)
            b, stats = self.engine.query_bgp(
                q, strategy="raw", backend="host", return_stats=True)
            status = "degraded"
        return BGPQueryResponse(
            rid=req.rid, variables=b.columns,
            rows=snap.fgraph.store.dict.decode_rows(b.rows),
            strategies=stats["plan"].strategies, n_rows=b.n_rows,
            status=status)

    def _shed(self, req):
        self.metrics.observe("wave.deadline_shed", 1)
        if isinstance(req, BGPQueryRequest):
            return BGPQueryResponse(req.rid, (), [], (), 0, status="shed")
        return GraphQueryResponse(req.rid, [], (), [], req.strategy, 0,
                                  status="shed")

    def run(self) -> dict:
        batch, self.queue = self.queue, []
        if not batch:
            return {}
        deadline = (None if self.wave_deadline_s is None
                    else self._clock() + self.wave_deadline_s)

        def overdue():
            return deadline is not None and self._clock() >= deadline

        # resolve the handle once: the whole wave -- compilation, batched
        # match, term decoding -- reads this one immutable snapshot
        snap = self._resolve()
        self.engine.rebind(snap.fgraph, snap.epoch)
        d = snap.fgraph.store.dict
        out: dict = {}
        bgps = [r for r in batch if isinstance(r, BGPQueryRequest)]
        batch = [r for r in batch if not isinstance(r, BGPQueryRequest)]
        for req in bgps:      # multi-star: planned + joined per request
            if overdue():     # deadline spent: explicit shed, not a drop
                out[req.rid] = self._shed(req)
                continue
            out[req.rid] = self._run_bgp(req, snap)
        if overdue():
            for req in batch:
                out[req.rid] = self._shed(req)
            return out
        compiled = [(req, _compile_star(req, d)) for req in batch]
        # factorized queries of the wave evaluate as ONE batch (device
        # backend: one molecule-match launch pair per class chunk)
        fact = [(req, q) for req, q in compiled
                if q is not None and req.strategy == "factorized"]
        degraded: set[int] = set()
        try:
            results = self.engine.query_batch([q for _, q in fact],
                                              backend=self.backend)
        except Exception:
            if self.backend == "device":
                raise
            # batched factorized path failed mid-wave: every factorized
            # request of this wave re-evaluates on the raw expansion
            self.metrics.observe("wave.raw_fallback", len(fact))
            results = [self.engine.query(q, strategy="raw")
                       for _, q in fact]
            degraded = {req.rid for req, _ in fact}
        by_rid = {req.rid: b for (req, _), b in zip(fact, results)}
        for req, q in compiled:
            if q is None:
                out[req.rid] = GraphQueryResponse(
                    req.rid, [], (), [], req.strategy, 0)
                continue
            b = by_rid.get(req.rid)
            if b is None:                       # raw strategy, host only
                if overdue():
                    out[req.rid] = self._shed(req)
                    continue
                b = self.engine.query(q, strategy=req.strategy)
            out[req.rid] = GraphQueryResponse(
                rid=req.rid,
                subjects=d.terms(b.subjects),
                var_props=tuple(d.terms(b.var_props)),
                var_objects=d.decode_rows(b.rows()[:, 1:]),
                strategy="raw" if req.rid in degraded else req.strategy,
                n_rows=b.n_rows,
                status="degraded" if req.rid in degraded else "ok")
        return out


class ShardedQueryService:
    """Fan-out request path over a
    :class:`~repro_torch.dist.graph.ShardedFactorizedGraph`.

    One bounded :class:`GraphQueryService` per shard is the request
    surface -- each shard keeps its own wave queue, and every per-shard
    knob (``max_pending`` admission bound, ``wave_deadline_s`` shedding,
    the host backend's raw fallback) applies *per shard*, exactly as on
    the replicated service.  Routing at submit:

    * class-constrained star requests enqueue on every shard that owns
      a chunk of the class (``ShardPlan.shards_for_class``).  Admission
      is all-or-nothing across the owners: if ANY owner's queue is full
      the whole submit sheds (``admission.shed``), never a torn fan-out.
    * classless star requests and BGP requests go to a coordinator
      queue (their answers need cross-shard per-arm unions / joins, not
      concatenation) evaluated by
      :class:`~repro_torch.dist.graph.ShardedQueryEngine` -- only binding
      sets cross shards, bounded by the service's own ``max_pending``
      and deadline.

    :meth:`run` drains every shard queue in parallel (one thread per
    shard, all on the one card; the kernel library loads once, and a
    launch that fails in a thread raises from :meth:`run`) and merges
    per request: typed subjects are uniquely owned, so the per-shard
    binding sets concatenate duplicate-free; the merged status is
    ``"shed"`` if any owner shed, else ``"degraded"`` if any owner
    degraded, else ``"ok"``.

    ``backend`` defaults to ``"device"`` on ``device`` (default
    ``"cuda"``, resolved at construction, so without CUDA the
    constructor raises).  On the device backend a failure of the
    coordinator's path raises, as it does in every shard's service; on
    the host backend it is answered from the raw expansion
    (``status="degraded"``, ``wave.raw_fallback``).

    Restart story: a shard rebuilt through ``repro_torch.online.recover()``
    swaps back in with ``sharded.swap_shard(sid, service.snapshot)``;
    the next wave's per-shard handle resolution picks up the new epoch
    with no coordination beyond the atomic tuple store.
    """

    def __init__(self, sharded, *, backend: str = "device", device="cuda",
                 max_pending: int | None = None,
                 wave_deadline_s: float | None = None,
                 metrics=None, clock=None):
        from ..dist.graph import ShardedQueryEngine
        from ..online.metrics import MetricsHub
        self.sharded = sharded
        self.backend = backend
        if backend == "device":
            device = resolve_device(device)
        self.device = device
        self.metrics = metrics if metrics is not None else MetricsHub()
        self._clock = clock if clock is not None else time.monotonic
        self.max_pending = max_pending
        self.wave_deadline_s = wave_deadline_s
        self.shards = [
            GraphQueryService(
                (lambda sid=sid: self.sharded.snapshots[sid]),
                backend=backend, device=device,
                max_pending=max_pending,
                wave_deadline_s=wave_deadline_s,
                metrics=self.metrics, clock=self._clock)
            for sid in range(sharded.n_shards)]
        self.coordinator = ShardedQueryEngine(sharded, device=device)
        self.queue: list = []            # coordinator-evaluated requests
        self._raw_engine = None          # degraded fallback, epoch-keyed

    @property
    def n_shards(self) -> int:
        return self.sharded.n_shards

    def _owners(self, req: GraphQueryRequest) -> tuple[int, ...] | None:
        """Owning shards for a class-routed star request; ``None`` when
        the request must evaluate at the coordinator instead."""
        if req.class_term is None:
            return None
        cid = self.sharded.dict.lookup(req.class_term)
        if cid is None:
            # unknown class: empty answer from any single shard
            return (0,)
        return self.sharded.plan.shards_for_class(int(cid))

    def submit(self, req) -> bool:
        """Admit ``req``; ``False`` (+ ``admission.shed``) when any
        target queue is full -- all-or-nothing across the fan-out."""
        owners = None if isinstance(req, BGPQueryRequest) \
            else self._owners(req)
        if owners is None:
            if self.max_pending is not None \
                    and len(self.queue) >= self.max_pending:
                self.metrics.observe("admission.shed", 1)
                return False
            self.queue.append(req)
            return True
        # capacity pre-check across every owner BEFORE any enqueue
        if any(s.max_pending is not None
               and len(s.queue) >= s.max_pending
               for s in (self.shards[sid] for sid in owners)):
            self.metrics.observe("admission.shed", 1)
            return False
        for sid in owners:
            self.shards[sid].submit(req)
        return True

    def _merge_star(self, rid: int, parts: list[GraphQueryResponse]
                    ) -> GraphQueryResponse:
        subjects: list[str] = []
        var_objects: list[tuple[str, ...]] = []
        var_props: tuple[str, ...] = ()
        for p in parts:
            subjects.extend(p.subjects)
            var_objects.extend(p.var_objects)
            if p.var_props:
                var_props = p.var_props
        status = "ok"
        if any(p.status == "degraded" for p in parts):
            status = "degraded"
        if any(p.status == "shed" for p in parts):
            status = "shed"     # partial: at least one owner unanswered
        self.sharded.traffic["query_bytes"] += sum(
            8 * (len(p.subjects) + sum(len(r) for r in p.var_objects))
            for p in parts)
        return GraphQueryResponse(
            rid=rid, subjects=subjects, var_props=var_props,
            var_objects=var_objects, strategy=parts[0].strategy,
            n_rows=len(subjects), status=status)

    def _degraded(self):
        """Replicated raw-expansion engine (built lazily per epoch) --
        the host backend's answers-stay-correct fallback when the
        sharded path fails."""
        from ..core.fgraph import FactorizedGraph
        from ..query import QueryEngine
        epoch = self.sharded.epoch
        if self._raw_engine is None or self._raw_engine[0] != epoch:
            fg = FactorizedGraph(self.sharded.expand_union(), {})
            self._raw_engine = (epoch, QueryEngine(fg, device=self.device))
        return self._raw_engine[1]

    def _coordinate(self, evaluate, fallback):
        """``(bindings, status)`` of one coordinator request: the sharded
        path, else -- on the host backend only -- the raw expansion."""
        try:
            return evaluate(), "ok"
        except Exception:
            if self.backend == "device":
                raise            # a device fault is never answered on host
            self.metrics.observe("wave.raw_fallback", 1)
            return fallback(self._degraded()), "degraded"

    def _run_coordinator(self, out: dict) -> None:
        deadline = (None if self.wave_deadline_s is None
                    else self._clock() + self.wave_deadline_s)
        batch, self.queue = self.queue, []
        d = self.sharded.dict
        for req in batch:
            if deadline is not None and self._clock() >= deadline:
                self.metrics.observe("wave.deadline_shed", 1)
                if isinstance(req, BGPQueryRequest):
                    out[req.rid] = BGPQueryResponse(req.rid, (), [], (),
                                                    0, status="shed")
                else:
                    out[req.rid] = GraphQueryResponse(
                        req.rid, [], (), [], req.strategy, 0,
                        status="shed")
                continue
            if isinstance(req, BGPQueryRequest):
                q = _compile_bgp_query(req, d)
                if q is None:
                    out[req.rid] = BGPQueryResponse(req.rid, (), [], (), 0)
                    continue
                b, status = self._coordinate(
                    lambda: self.coordinator.query_bgp(
                        q, strategy=req.strategy, backend=self.backend),
                    lambda eng: eng.query_bgp(q, strategy="raw"))
                out[req.rid] = BGPQueryResponse(
                    rid=req.rid, variables=b.columns,
                    rows=d.decode_rows(b.rows), strategies=(),
                    n_rows=b.n_rows, status=status)
            else:                        # classless star
                q = _compile_star(req, d)
                if q is None:
                    out[req.rid] = GraphQueryResponse(
                        req.rid, [], (), [], req.strategy, 0)
                    continue
                b, status = self._coordinate(
                    lambda: self.coordinator.query(
                        q, strategy=req.strategy),
                    lambda eng: eng.query(q, strategy="raw"))
                out[req.rid] = GraphQueryResponse(
                    rid=req.rid, subjects=d.terms(b.subjects),
                    var_props=tuple(d.terms(b.var_props)),
                    var_objects=d.decode_rows(b.rows()[:, 1:]),
                    strategy=req.strategy, n_rows=b.n_rows, status=status)

    def run(self) -> dict:
        """Drain one wave: shard queues in parallel (one thread per
        shard -- each thread touches only its own service; an exception
        in one is re-raised here), the coordinator queue on the caller's
        thread, then the fan-out merge."""
        from concurrent.futures import ThreadPoolExecutor
        out: dict = {}
        self.coordinator.rebind()
        busy = [s for s in self.shards if s.queue]
        shard_outs = []
        if busy:
            with ThreadPoolExecutor(max_workers=len(busy)) as ex:
                shard_outs = list(ex.map(lambda s: s.run(), busy))
        self._run_coordinator(out)
        by_rid: dict[int, list] = {}
        for responses in shard_outs:
            for rid, resp in responses.items():
                by_rid.setdefault(rid, []).append(resp)
        for rid, parts in by_rid.items():
            out[rid] = self._merge_star(rid, parts)
        return out
