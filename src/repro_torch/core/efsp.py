"""gSpan pattern-space construction for the E.FSP baseline paths.

The paper's Algorithm 1 consumes the frequent-pattern space enumerated by
gSpan over the RDF molecules of a class (``subgraphsDict``: property
subset -> the star subgraphs over that subset).  Materializing that space
is exponential -- the cost the paper's Table 3 attributes to E.FSP and
that G.FSP avoids (>= 3 orders of magnitude).

The default exhaustive detector does not pay it:
``repro_torch.api.ExhaustiveDetector`` scans the property-subset lattice
level by level through the candidate-batched sweep workspaces.
``build_subgraphs_dict`` is (a) the input of the ``gspan`` baseline
detector and (b) the legacy Algorithm-1 path, selected by passing
``subgraphs_dict=`` or ``min_support > 1``.

``subgraphsDict`` construction: gSpan patterns over star molecules are
star-shaped DFS codes rooted at the class vertex; each pattern fixes a set
of properties and one object tuple.  Grouping patterns by their property
set yields the dictionary of Algorithm 1; the number of patterns per subset
is AMI, and countEdges follows Def. 4.8.
"""
from __future__ import annotations

from .gspan import mine, molecules_of_class
from .triples import TripleStore


def build_subgraphs_dict(store: TripleStore, class_id: int,
                         min_support: int = 1,
                         max_edges: int | None = None):
    """Enumerate the gSpan pattern space and bucket star patterns by
    property subset.

    Returns ``(subgraphs_dict, n_patterns, entities)`` where
    ``subgraphs_dict[frozenset(props)] = list[(object_tuple, support)]``.
    """
    ents, graphs = molecules_of_class(store, class_id)
    patterns = mine(graphs, min_support=min_support, max_edges=max_edges)
    subgraphs: dict[frozenset, list[tuple[tuple, int]]] = {}
    for pat in patterns:
        # star pattern rooted at the class vertex: every edge is a forward
        # edge (0, k, class, p, 1, o)
        if not all(t[0] == 0 and t[4] == 1 for t in pat.code):
            continue
        props = tuple(sorted(t[3] for t in pat.code))
        if len(set(props)) != len(props):
            continue  # functional-property duplicates are not star patterns
        objs = tuple(o for _, o in sorted((t[3], t[5]) for t in pat.code))
        subgraphs.setdefault(frozenset(props), []).append((objs, pat.support))
    return subgraphs, len(patterns), ents
