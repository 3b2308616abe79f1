"""Device meshes for the sharded compaction path.

The port's counterpart of ``compat.make_mesh`` and
``launch/mesh.py::make_test_mesh``.  The JAX package is single-
controller: one process drives a ``Mesh`` of devices through
``shard_map``.  So is the port: one process, and a :class:`Mesh` whose
entries are ``torch.device`` objects.  Each shard's tensors live on its
entry's device, and the sharded kernels' exchange moves slab ``j`` of
every source shard to shard ``j``'s device
(:func:`repro_torch.core.distributed.ami_bucketed_batch`).  On one card
every entry is ``cuda:0`` and the exchange is a permutation on the card.

What ``make_plan`` reads of a mesh (``.axis_names`` and ``.devices``,
an object array in the mesh's shape) is all a :class:`Mesh` holds.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels.ops import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over an object array of ``torch.device``."""

    axis_names: tuple[str, ...]
    devices: np.ndarray

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        kinds = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={kinds})"


def make_mesh(shape, axis_names, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axis_names``.

    ``devices``: ``None`` puts ``cuda:0`` in every entry (the one card);
    a single device (``"cpu"``, ``"cuda:0"``, a ``torch.device``) goes in
    every entry; a sequence gives one device per entry in row-major
    order.  Every entry is resolved through ``kernels.ops.resolve_device``,
    so a CUDA entry on a host without CUDA raises."""
    shape = tuple(int(s) for s in shape)
    names = tuple(str(a) for a in axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} does not match axes {names}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    n = math.prod(shape)
    if devices is None:
        devices = "cuda:0"
    if isinstance(devices, (str, torch.device)):
        flat = [resolve_device(devices)] * n
    else:
        flat = [resolve_device(d) for d in devices]
        if len(flat) != n:
            raise ValueError(f"{len(flat)} devices for a mesh of {n} entries")
    arr = np.empty((n,), object)
    arr[:] = flat
    return Mesh(axis_names=names, devices=arr.reshape(shape))


def make_test_mesh(shape=(1, 1), axes=("data", "model"), devices="cpu"
                   ) -> Mesh:
    """A small mesh for tests, on the CPU unless told otherwise."""
    return make_mesh(shape, axes, devices)


__all__ = ["Mesh", "make_mesh", "make_test_mesh"]
