"""Deterministic sharded LM data pipeline (synthetic tokens).

The port's copy of ``repro/data/lm_pipeline.py`` (numpy, no jax): the
same seed gives the same tokens, so ``batch_at(step)`` equals the JAX
pipeline's.  Production properties needed at 1000+ nodes, all present
here:

* **Determinism + skip-ahead**: batch ``k`` is a pure function of
  (seed, k) -- restart at step k after a failure without replaying k
  batches (``batch_at``);
* **Host sharding**: each data-parallel host materializes only its slice
  (``host_slice``), so the global batch never exists on one host;
* **Straggler rebalance hook**: ``reassign`` re-partitions the host->slice
  map when the fault monitor (dist/fault.py) marks a host slow, keeping
  the global batch content IDENTICAL (same seed/step) while shrinking the
  slow host's share;
* **Factorized storage**: repeated documents live in a FactorizedStore
  (the paper's technique on the data plane).

Token stream: Zipf-ish synthetic ids with repeated "template" documents,
so compression/factorization behave like real corpora.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .factorized_store import FactorizedStore


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_templates: int = 64            # distinct repeated documents
    template_frac: float = 0.5       # fraction of rows drawn from templates


class LMPipeline:
    def __init__(self, spec: PipelineSpec):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        self.templates = rng.integers(
            1, spec.vocab_size, (spec.n_templates, spec.seq_len),
            dtype=np.int32)

    # -- global batch ----------------------------------------------------------
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The full global batch for ``step`` (pure function of step)."""
        sp = self.spec
        rng = np.random.default_rng((sp.seed, step))
        n_templ = int(sp.global_batch * sp.template_frac)
        t_idx = rng.integers(0, sp.n_templates, (n_templ,))
        fresh = rng.integers(1, sp.vocab_size,
                             (sp.global_batch - n_templ, sp.seq_len),
                             dtype=np.int32)
        tokens = np.concatenate([self.templates[t_idx], fresh], axis=0)
        perm = rng.permutation(sp.global_batch)
        tokens = tokens[perm]
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = 0
        mask = np.ones_like(tokens, np.float32)
        mask[:, -1] = 0.0
        return {"tokens": tokens, "labels": labels, "mask": mask}

    # -- host sharding -----------------------------------------------------------
    def host_slice(self, step: int, host: int, n_hosts: int,
                   shares: np.ndarray | None = None) -> dict[str, np.ndarray]:
        """This host's rows of batch ``step``.

        ``shares``: optional per-host row counts (sum == global_batch) from
        the straggler rebalancer; default: equal split."""
        sp = self.spec
        if shares is None:
            assert sp.global_batch % n_hosts == 0
            shares = np.full((n_hosts,), sp.global_batch // n_hosts)
        bounds = np.concatenate([[0], np.cumsum(shares)])
        full = self.batch_at(step)
        lo, hi = int(bounds[host]), int(bounds[host + 1])
        return {k: v[lo:hi] for k, v in full.items()}

    @staticmethod
    def reassign(n_hosts: int, global_batch: int,
                 slow: set[int], slow_share: float = 0.5) -> np.ndarray:
        """Shrink slow hosts' shares; redistribute to healthy hosts."""
        shares = np.full((n_hosts,), global_batch // n_hosts, np.int64)
        for h in sorted(slow):
            cut = int(shares[h] * slow_share)
            shares[h] -= cut
            healthy = [i for i in range(n_hosts) if i not in slow]
            for i, extra in zip(healthy, _split(cut, len(healthy))):
                shares[i] += extra
        assert shares.sum() == global_batch
        return shares

    # -- factorized corpus ---------------------------------------------------------
    def factorized_corpus(self, n_rows: int) -> FactorizedStore:
        sp = self.spec
        rng = np.random.default_rng(sp.seed + 1)
        n_templ = int(n_rows * sp.template_frac)
        rows = np.concatenate([
            self.templates[rng.integers(0, sp.n_templates, (n_templ,))],
            rng.integers(1, sp.vocab_size, (n_rows - n_templ, sp.seq_len),
                         dtype=np.int32)])
        return FactorizedStore.build(rows)


def _split(total: int, parts: int) -> list[int]:
    base, rem = divmod(total, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]
