"""Carry a graph, or an LM's weights, across from the JAX package.

The port's "weights" are the graph itself: the dictionary's terms in id
order plus the ``(n, 3)`` int32 id array.  :func:`store_from_arrays`
rebuilds a :class:`~repro_torch.core.triples.TripleStore` from exactly
those two, so both packages see the same ids, the same sorted rows and
therefore the same surrogate ids when they factorize.

    store = repro.data.synthetic.generate(spec)          # reference
    ported = store_from_arrays(list(store.dict._terms), store.spo)

An LM's weights cross as the JAX param tree with numpy leaves; the
result loads into the port's ``LM`` of the same config.  A homogeneous
stack's tree is layer-stacked in the JAX package (``layers.attn.wq`` of
shape ``(L, ...)``); it is unstacked into ``layers.<i>.attn.wq``:

    tree = jax.tree.map(np.asarray, repro_lm.init(key))   # reference
    model = LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(cfg, tree))

The same mapping runs the other way for the optimizer, which decides
per JAX leaf (:func:`jax_leaves` groups a stack's per-layer tensors back
under the leaf's path), and a JAX ``TrainState`` crosses with
:func:`train_state_from_jax`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import obs
from .core.triples import TermDict, TripleStore


def store_from_arrays(terms: Sequence[str], spo: np.ndarray) -> TripleStore:
    """A store over the dictionary ``terms`` (id = position) and the id
    rows ``spo``; rows are sorted and deduplicated as on ingest."""
    spo = np.asarray(spo, np.int32).reshape(-1, 3)
    if spo.size and (spo.min() < 0 or spo.max() >= len(terms)):
        raise ValueError("spo holds ids outside the dictionary")
    with obs.span("store.load", rows=int(spo.shape[0])):
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


def unstack_layers(stacked: dict, n_layers: int,
                   path: str = "layers") -> list[dict]:
    """A layer-stacked tree (every leaf ``(L, ...)``, an MoE's expert
    weights ``(L, E, ...)``) as a list of ``L`` per-layer trees of numpy
    leaves; raises on a leaf without that leading dimension."""
    def take(node, i, path):
        if isinstance(node, dict):
            return {k: take(v, i, f"{path}.{k}") for k, v in node.items()}
        arr = np.asarray(node)
        if arr.ndim == 0 or arr.shape[0] != n_layers:
            raise ValueError(f"{path}: a layer-stacked leaf needs a leading "
                             f"dimension of {n_layers}, got {arr.shape}")
        return arr[i]
    return [take(stacked, i, path) for i in range(n_layers)]


def lm_params_from_jax(cfg, tree) -> dict[str, torch.Tensor]:
    """The JAX ``LM.param_specs`` tree of ``cfg`` (numpy leaves) as the
    port's ``state_dict``: ``{"embed": ..., "layers.0.rglru.w_x": ...}``,
    a layer-stacked ``layers`` dict (with an encoder-decoder's ``xattn``
    leaves merged in) and ``encoder.layers`` unstacked first.  Raises if
    a name or shape differs from the port's ``LM`` of ``cfg``."""
    from .models.common import torch_dtype
    from .models.lm import LM
    specs = LM.param_specs(cfg)
    if isinstance(tree.get("layers"), dict):
        tree = {**tree, "layers": unstack_layers(tree["layers"],
                                                 cfg.n_layers)}
    if isinstance(tree.get("encoder", {}).get("layers"), dict):
        enc = tree["encoder"]
        tree = {**tree, "encoder": {**enc, "layers": unstack_layers(
            enc["layers"], cfg.encoder_layers, "encoder.layers")}}
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


def _stacked_path(cfg, name: str) -> str | None:
    """The JAX leaf a per-layer parameter name belongs to when that leaf
    is layer-stacked (``layers.3.attn.wq`` -> ``layers.attn.wq`` in a
    homogeneous stack; the encoder's layers always), else None."""
    parts = name.split(".")
    if parts[0] == "layers" and cfg.homogeneous:
        return ".".join(["layers"] + parts[2:])
    if parts[:2] == ["encoder", "layers"]:
        return ".".join(["encoder", "layers"] + parts[3:])
    return None


def jax_leaves(cfg, named: dict) -> dict:
    """The port's ``{name: tensor}`` (``named_parameters`` order) as the
    JAX package's leaves: ``{path: tensor}`` for a leaf the JAX tree
    keeps whole, ``{path: [layer 0's tensor, layer 1's, ...]}`` for a
    layer-stacked one.  The tensors are the same objects, not copies."""
    out: dict = {}
    for name, t in named.items():
        path = _stacked_path(cfg, name)
        if path is None:
            out[name] = t
        else:
            out.setdefault(path, []).append((int(name.split(".")[
                2 if name.startswith("encoder.") else 1]), t))
    return {k: [t for _, t in sorted(v, key=lambda it: it[0])]
            if isinstance(v, list) else v for k, v in out.items()}


def train_state_from_jax(cfg, state):
    """A JAX ``TrainState`` (params, AdamW ``m``/``v`` or Adafactor
    ``vr``/``vc``/``v`` (or either inside ``compressed``'s ``inner``,
    with its ``ef``), step) as the port's: ``TrainState(params, opt,
    step)`` with ``params`` a ``state_dict`` for ``LM.load_state_dict``
    and ``opt`` keyed by JAX leaf path, stacked as the JAX leaves are
    (the port's optimizers keep it so).  Leaves may be jax or numpy
    arrays.  Load it with ``train.train_step.load_train_state``."""
    from .train.train_step import TrainState

    def tensors(tree):
        return {path: _to_tensor(leaf) for path, leaf in _flatten(tree)}

    def opt_of(opt):
        if "inner" in opt:
            return {"inner": opt_of(opt["inner"]), "ef": tensors(opt["ef"])}
        if "f" in opt:
            out: dict = {}
            for path, t in tensors(opt["f"]).items():
                leaf, kind = path.rsplit(".", 1)
                out.setdefault(leaf, {})[kind] = t
            return {"f": out}
        return {"m": tensors(opt["m"]), "v": tensors(opt["v"])}

    params = lm_params_from_jax(cfg, state.params)
    return TrainState(params, opt_of(state.opt), int(np.asarray(state.step)))
