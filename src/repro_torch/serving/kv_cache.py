"""KV cache pool for the serving engine.

The port's copy of ``repro/serving/kv_cache.py``: a host-side slot
manager (:class:`KVPool`: alloc, free, active slots, occupancy; a
finished request's slot is reusable at once) and
:func:`molecule_broadcast`, which copies each shared-prefix molecule's
cache into the slots of its instances with one gather per tensor.  The
JAX version takes layer-stacked ``(L, B, ...)`` leaves; the port's
caches are a per-layer list of dicts whose tensors have batch on axis 0
(``LM.prefill``), so this one takes that layout.  The port's ``Engine``
uses neither, as the JAX ``Engine`` does not.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SlotState:
    request_id: int | None = None
    length: int = 0                  # tokens currently cached


class KVPool:
    def __init__(self, n_slots: int):
        self.slots = [SlotState() for _ in range(n_slots)]

    def alloc(self, request_id: int) -> int:
        for i, s in enumerate(self.slots):
            if s.request_id is None:
                self.slots[i] = SlotState(request_id, 0)
                return i
        raise RuntimeError("KV pool exhausted")

    def free(self, slot: int) -> None:
        self.slots[slot] = SlotState()

    def active(self) -> list[int]:
        return [i for i, s in enumerate(self.slots)
                if s.request_id is not None]

    def occupancy(self) -> float:
        return len(self.active()) / max(len(self.slots), 1)


def molecule_broadcast(cache_layers: list, molecule_cache: list,
                       instance_of: np.ndarray) -> list:
    """Copy each molecule's prefix cache into its instance slots.

    ``cache_layers`` / ``molecule_cache``: per-layer lists of matching
    nested dicts of tensors, (B, ...) / (M, ...).  ``instance_of[b]`` is
    request b's molecule.  A (B, heads, S, hd) tensor takes the
    molecule's first positions of S, any other the first positions of
    its axis 1 (the JAX rule, one axis down).  Returns new caches; the
    inputs are not changed."""
    idx = torch.as_tensor(np.asarray(instance_of), dtype=torch.long)

    def leaf(full, mol):
        if isinstance(full, dict):
            return {k: leaf(full[k], mol[k]) for k in full}
        take = mol[idx.to(mol.device)]                 # (B, ...) per request
        out = full.clone()
        if full.ndim == 4:
            out[:, :, :take.shape[2]] = take
        else:
            out[:, :take.shape[1]] = take
        return out

    return [leaf(f, m) for f, m in zip(cache_layers, molecule_cache)]
