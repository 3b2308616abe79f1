"""Elastic re-meshing: shrink the mesh after device loss and keep going.

The port's copy of ``repro/dist/elastic.py`` over the port's
:class:`~.mesh.Mesh`.  After losing devices, rebuild a ``(data, model)``
mesh over the survivors.  The model axis wants to stay a power of two
(TP collectives degrade badly on odd rings) and no wider than
``max_model``, so :func:`choose_mesh_shape` gives it the largest
power-of-two divisor of the survivor count up to that cap and hands the
rest to data.  The cap defaults to 8, one HGX H100 node's NVLink domain
(the JAX package's 16 was one TPU ICI torus edge).

Checkpoints are layout-free (host numpy), so a restore onto the new
mesh is the whole recovery story: ``Checkpointer.restore(like,
shardings=...)`` places every leaf on its sharding's device.
"""
from __future__ import annotations

from .mesh import Mesh, make_mesh

MAX_MODEL = 8            # one HGX H100 node: 8 cards on one NVLink switch


def choose_mesh_shape(n_devices: int, *, max_model: int = MAX_MODEL
                      ) -> tuple[int, int]:
    """``n_devices`` -> (data, model); always ``data * model ==
    n_devices``."""
    if n_devices <= 0:
        raise ValueError(f"need at least one device, got {n_devices}")
    model = 1
    while model * 2 <= max_model and n_devices % (model * 2) == 0:
        model *= 2
    return n_devices // model, model


def remesh(n_devices: int | None = None, *, tp_pref: int | None = None,
           devices=None, max_model: int = MAX_MODEL) -> Mesh:
    """A fresh ``(data, model)`` mesh over the surviving devices.

    ``devices`` is the survivor list (e.g. the healthy ones the fault
    monitor reports); without it ``cuda:0 ... cuda:{n-1}`` are taken,
    which is right only when the *tail* of the fleet died.  ``tp_pref``
    pins the model-axis width when it divides the survivor count (keep
    the TP degree stable across a shrink); otherwise
    :func:`choose_mesh_shape` decides.
    """
    if devices is None:
        if n_devices is None:
            raise ValueError("remesh needs n_devices or a device list")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"asked for {n_devices} devices, only {len(devices)} alive")
    if tp_pref and n_devices % tp_pref == 0:
        shape = (n_devices // tp_pref, tp_pref)
    else:
        shape = choose_mesh_shape(n_devices, max_model=max_model)
    return make_mesh(shape, ("data", "model"), devices[:n_devices])


__all__ = ["MAX_MODEL", "choose_mesh_shape", "remesh"]
