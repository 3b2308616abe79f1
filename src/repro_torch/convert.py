"""Carry a graph, or an LM's weights, across from the JAX package.

The port's "weights" are the graph itself: the dictionary's terms in id
order plus the ``(n, 3)`` int32 id array.  :func:`store_from_arrays`
rebuilds a :class:`~repro_torch.core.triples.TripleStore` from exactly
those two, so both packages see the same ids, the same sorted rows and
therefore the same surrogate ids when they factorize.

    store = repro.data.synthetic.generate(spec)          # reference
    ported = store_from_arrays(list(store.dict._terms), store.spo)

An LM's weights cross as the JAX param tree with numpy leaves; the
result loads into the port's ``LM`` of the same config:

    tree = jax.tree.map(np.asarray, repro_lm.init(key))   # reference
    model = LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(cfg, tree))
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.triples import TermDict, TripleStore


def store_from_arrays(terms: Sequence[str], spo: np.ndarray) -> TripleStore:
    """A store over the dictionary ``terms`` (id = position) and the id
    rows ``spo``; rows are sorted and deduplicated as on ingest."""
    spo = np.asarray(spo, np.int32).reshape(-1, 3)
    if spo.size and (spo.min() < 0 or spo.max() >= len(terms)):
        raise ValueError("spo holds ids outside the dictionary")
    return TripleStore.from_ids(TermDict.from_terms(terms), spo)


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":        # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def lm_params_from_jax(cfg, tree) -> dict[str, torch.Tensor]:
    """The JAX ``LM.param_specs`` tree of ``cfg`` (numpy leaves) as the
    port's ``state_dict``: ``{"embed": ..., "layers.0.rglru.w_x": ...}``.
    Raises if a name or shape differs from the port's ``LM`` of ``cfg``."""
    from .models.common import torch_dtype
    from .models.lm import LM
    specs = LM.param_specs(cfg)
    out = {name: _to_tensor(leaf) for name, leaf in _flatten(tree)}
    if set(out) != set(specs):
        raise ValueError(f"param names differ: missing "
                         f"{sorted(set(specs) - set(out))}, unexpected "
                         f"{sorted(set(out) - set(specs))}")
    for name, t in out.items():
        s = specs[name]
        if tuple(t.shape) != s.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {s.shape}")
        out[name] = t.to(torch_dtype(s.dtype))
    return out
