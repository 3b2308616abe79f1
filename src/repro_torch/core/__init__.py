"""The paper's algorithms and graph primitives: dictionary-encoded
triples with a per-predicate index (and its bit-packed compressed tier,
``core.compress``), the Def. 4.4-4.8 counting formulas (host numpy and
device torch), the bucketed sweep workspaces, the gSpan miner behind the
E.FSP baseline paths, factorization (Algorithm 3), the Def. 4.11 axioms
and the factorized graph structure."""
from .triples import TermDict, TripleStore, RDF_TYPE, INSTANCE_OF  # noqa: F401
from .index import GraphIndex, in_sorted, merge_disjoint, sort_unique  # noqa: F401
from .star import (ami, multiplicities, num_edges, evaluate_subset,  # noqa: F401
                   star_groups, row_groups, StarSweepResult)
from .sweep import (SweepWorkspace, HostSweepWorkspace,  # noqa: F401
                    DeviceSweepWorkspace, pick_child)
from .gfsp import FSPResult  # noqa: F401
from .efsp import build_subgraphs_dict  # noqa: F401
from .factorize import factorize_classes, FactorizationResult  # noqa: F401
from .fgraph import FactorizedGraph, MoleculeTable  # noqa: F401
from .axioms import expand, semantic_triples, match_star  # noqa: F401
