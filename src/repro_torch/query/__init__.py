"""Star-query engine over the compact form (no expansion).

``StarQuery`` describes a star BGP (subject variable, (property,
object-or-variable) arms, optional class) and :class:`QueryEngine`
answers it on a ``FactorizedGraph``:

    from repro_torch.api import Compactor
    from repro_torch.query import QueryEngine, StarQuery

    comp = Compactor(); comp.run(store)
    eng = QueryEngine(comp.fgraph)
    eng.query(q)                             # factorized: molecule match
    eng.query(q, strategy="raw")             # index joins on expand()
    eng.query_batch(qs, backend="device")    # one launch pair per stack

Multi-star BGPs with FILTERs ride the :mod:`repro_torch.query.bgp`
subsystem (``QueryEngine.query_bgp``): molecule-level cross-star joins,
filter pushdown into molecule object columns, and a cost-based planner
that replaces the ``strategy=`` flag (kept as an override).
"""
from .batch import (QUERY_EXEC, QueryEngine, match_molecules_batch,  # noqa: F401
                    reset_query_stats)
from .bgp import (BGPBindings, BGPPlan, BGPQuery, Filter,  # noqa: F401
                  StarPattern, eval_bgp_reference, execute_bgp, plan_bgp)
from .star import (Bindings, StarQuery, eval_factorized, eval_raw,  # noqa: F401
                   match_molecules)

__all__ = ["StarQuery", "Bindings", "QueryEngine", "eval_raw",
           "eval_factorized", "match_molecules", "match_molecules_batch",
           "QUERY_EXEC", "reset_query_stats",
           "BGPQuery", "BGPBindings", "BGPPlan", "Filter", "StarPattern",
           "plan_bgp", "execute_bgp", "eval_bgp_reference"]
