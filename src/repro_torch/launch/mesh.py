"""Production mesh of H100s and the card's published peaks.

The H100 counterpart of ``repro/launch/mesh.py`` (a TPU v5e-class chip
there).  The peaks are per GPU, from NVIDIA's H100 SXM data sheet and
the interconnects' own specifications, at the card's full 700 W limit;
the roofline of :mod:`.roofline`, the dry run, ``chip_smoke.py`` and
``tools/time_kernels.py`` read them from here.

``make_production_mesh`` is a function, not a constant: it builds a
:class:`~..dist.mesh.Mesh` of ``meta`` devices by default, so the dry
run lays out 256 or 512 GPUs without opening any card.
"""
from __future__ import annotations

from ..dist.mesh import Mesh, make_mesh, make_test_mesh  # noqa: F401

# dense bf16 on the tensor cores, H100 SXM (data sheet: 989 TFLOP/s
# without sparsity)
PEAK_FLOPS_BF16 = 989e12
# float32 on the CUDA cores, outside the tensor cores (data sheet)
PEAK_FLOPS_F32 = 67e12
# HBM3, 80 GB at 3.35 TB/s (data sheet)
HBM_BW = 3.35e12
# NVLink 4: 900 GB/s per GPU to the other GPUs of an HGX node, all to
# all through the NVSwitches, 450 GB/s each way
NVLINK_BW = 450e9
# InfiniBand NDR, one ConnectX-7 at 400 Gb/s per GPU: 50 GB/s each way
IB_BW = 50e9

# the link a collective over each mesh axis crosses: the tensor-parallel
# "model" axis stays inside a node (8 GPUs on NVLink), "data" and "pod"
# go between nodes over InfiniBand
AXIS_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}

GPUS_PER_NODE = 8


def make_production_mesh(*, multi_pod: bool = False,
                         devices="meta") -> Mesh:
    """256 H100s as 32 nodes of 8, ``(32, 8)`` over ``("data",
    "model")``, tensor-parallel inside a node; ``multi_pod``: two such
    pods, ``(2, 32, 8)`` over ``("pod", "data", "model")``, 512 GPUs (the
    JAX dry run's chip counts)."""
    shape = (2, 32, GPUS_PER_NODE) if multi_pod else (32, GPUS_PER_NODE)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


__all__ = ["AXIS_BW", "GPUS_PER_NODE", "HBM_BW", "IB_BW", "NVLINK_BW",
           "PEAK_FLOPS_BF16", "PEAK_FLOPS_F32", "make_production_mesh",
           "make_test_mesh"]
