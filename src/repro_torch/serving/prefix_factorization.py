"""The paper's factorization, transferred to LM serving.

The port's copy of ``repro/serving/prefix_factorization.py`` (numpy,
no device work), on the port's own ``core.star.row_groups``.

Mapping: a batch of requests sharing a prompt prefix IS a
frequent star pattern --

  entity (subject)  = request
  property p_i      = prefix chunk position i
  object o_i        = the token block at chunk i
  compact molecule  = ONE shared KV segment for the common prefix
  surrogate entity  = the shared segment's id
  instanceOf edge   = the per-request pointer to the shared segment

and the paper's #Edges objective (Def. 4.8) becomes a BYTES objective
deciding how deep to share:

  cost(d) = sum_{i<d} distinct_prefixes(i) * chunk_kv_bytes     (molecules)
          + R * (L - d*c) * token_kv_bytes                      (suffixes)
          + R * ptr_bytes * (d > 0)                             (instanceOf)

``distinct_prefixes(i)`` is exactly the paper's AMI over the first i+1
"properties" (chunk positions), computed with the same row-group
machinery (core.star.row_groups).  The paper's factorization-overhead
case (Fig. 7 -- sharing that GROWS the graph) appears verbatim: for
unique prompts or tiny chunks, cost(d) is minimized at d = 0 and the
planner declines to share.

Losslessness (Def. 4.10/4.11 analog): expanding each request's pointer
chain reproduces its full token sequence -- asserted in tests, and the
engine validates shared-vs-unshared logits agree.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.star import row_groups


@dataclasses.dataclass(frozen=True)
class PrefixPlan:
    depth_chunks: int                 # chosen sharing depth d*
    chunk: int
    molecule_tokens: np.ndarray       # (n_molecules, d*chunk) shared prefixes
    instance_of: np.ndarray           # (R,) request -> molecule id (-1: none)
    suffix_start: int                 # tokens from here on are per-request
    cost_shared: float
    cost_unshared: float

    @property
    def shares(self) -> bool:
        return self.depth_chunks > 0

    @property
    def savings_pct(self) -> float:
        """%Savings metric of the paper (Table 5), in KV bytes."""
        if self.cost_unshared == 0:
            return 0.0
        return 100.0 * (1 - self.cost_shared / self.cost_unshared)


def prefix_edges_cost(tokens: np.ndarray, d: int, chunk: int,
                      kv_bytes_per_token: float,
                      ptr_bytes: float = 8.0) -> float:
    """#Edges (Def. 4.8) in bytes for sharing depth ``d`` (chunks)."""
    r, length = tokens.shape
    cost = r * (length - d * chunk) * kv_bytes_per_token
    if d > 0:
        cost += r * ptr_bytes
        for i in range(1, d + 1):
            _, counts, _ = row_groups(tokens[:, :i * chunk])
            cost += counts.shape[0] * chunk * kv_bytes_per_token
    return float(cost)


def plan_prefix_sharing(tokens: np.ndarray, *, chunk: int = 128,
                        kv_bytes_per_token: float,
                        ptr_bytes: float = 8.0) -> PrefixPlan:
    """Greedy depth descent (G.FSP analog): start from the deepest
    shareable prefix and stop when the bytes objective stops improving
    (Theorem 4.1's monotonicity holds here too: once extending the shared
    depth is a loss, deeper extensions only add molecules)."""
    tokens = np.asarray(tokens)
    r, length = tokens.shape
    max_d = length // chunk
    base = float(r * length * kv_bytes_per_token)     # d = 0
    best_d, best_cost = 0, base
    # incremental greedy: walk depth upward while the objective improves
    cum = base
    for d in range(1, max_d + 1):
        _, counts, _ = row_groups(tokens[:, :d * chunk])
        n_mol = counts.shape[0]
        # marginal change of moving chunk d-1 from per-request to shared:
        cum = prefix_edges_cost(tokens, d, chunk, kv_bytes_per_token,
                                ptr_bytes)
        if cum < best_cost:
            best_d, best_cost = d, cum
        elif n_mol == r:
            break            # fully distinct already: deeper never helps
    if best_d == 0:
        return PrefixPlan(0, chunk, np.empty((0, 0), tokens.dtype),
                          np.full((r,), -1, np.int64), 0, base, base)
    inv, counts, rep = row_groups(tokens[:, :best_d * chunk])
    molecules = tokens[rep][:, :best_d * chunk]
    return PrefixPlan(best_d, chunk, molecules, inv,
                      best_d * chunk, best_cost, base)


def expand(plan: PrefixPlan, suffixes: np.ndarray) -> np.ndarray:
    """Inverse transformation (instanceOf axioms): rebuild full sequences."""
    if not plan.shares:
        return suffixes
    return np.concatenate(
        [plan.molecule_tokens[plan.instance_of], suffixes], axis=1)
