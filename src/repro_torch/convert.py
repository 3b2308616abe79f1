"""Carry a graph across from the JAX package.

The port's "weights" are the graph itself: the dictionary's terms in id
order plus the ``(n, 3)`` int32 id array.  :func:`store_from_arrays`
rebuilds a :class:`~repro_torch.core.triples.TripleStore` from exactly
those two, so both packages see the same ids, the same sorted rows and
therefore the same surrogate ids when they factorize.

    store = repro.data.synthetic.generate(spec)          # reference
    ported = store_from_arrays(list(store.dict._terms), store.spo)
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .core.triples import TermDict, TripleStore


def store_from_arrays(terms: Sequence[str], spo: np.ndarray) -> TripleStore:
    """A store over the dictionary ``terms`` (id = position) and the id
    rows ``spo``; rows are sorted and deduplicated as on ingest."""
    spo = np.asarray(spo, np.int32).reshape(-1, 3)
    if spo.size and (spo.min() < 0 or spo.max() >= len(terms)):
        raise ValueError("spo holds ids outside the dictionary")
    return TripleStore.from_ids(TermDict.from_terms(terms), spo)
