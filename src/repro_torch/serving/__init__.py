"""Serving: the batched LM ``Engine`` with factorized shared prefixes,
``GraphQueryService``, the star- and BGP-query endpoint over a compacted
graph, and ``ShardedQueryService``, its fan-out over a sharded graph.
"""
from .engine import (PREFIX_POLICIES, BGPQueryRequest,  # noqa: F401
                     BGPQueryResponse, Engine, GraphQueryRequest,
                     GraphQueryResponse, GraphQueryService, PrefixPolicy,
                     Request, ShardedQueryService)
from .prefix_factorization import (PrefixPlan, expand,  # noqa: F401
                                   plan_prefix_sharing, prefix_edges_cost)
