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
