"""LM serving: the batched ``Engine`` with factorized shared prefixes.

``GraphQueryService`` and the sharded service of the JAX package wait
for a later slice.
"""
from .engine import (PREFIX_POLICIES, Engine, PrefixPolicy,  # noqa: F401
                     Request)
from .prefix_factorization import (PrefixPlan, expand,  # noqa: F401
                                   plan_prefix_sharing, prefix_edges_cost)
