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
"""
from .batch import QueryEngine, match_molecules_batch  # noqa: F401
from .star import (Bindings, StarQuery, eval_factorized, eval_raw,  # noqa: F401
                   match_molecules)

__all__ = ["StarQuery", "Bindings", "QueryEngine", "eval_raw",
           "eval_factorized", "match_molecules", "match_molecules_batch"]
