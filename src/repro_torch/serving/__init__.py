"""Serving: the batched LM ``Engine`` with factorized shared prefixes,
and ``GraphQueryService``, the star- and BGP-query endpoint over a
compacted graph.

The sharded fan-out service of the JAX package waits for the sharded
backend.
"""
from .engine import (PREFIX_POLICIES, BGPQueryRequest,  # noqa: F401
                     BGPQueryResponse, Engine, GraphQueryRequest,
                     GraphQueryResponse, GraphQueryService, PrefixPolicy,
                     Request)
from .prefix_factorization import (PrefixPlan, expand,  # noqa: F401
                                   plan_prefix_sharing, prefix_edges_cost)
