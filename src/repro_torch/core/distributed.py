"""Distributed FSP detection over a device mesh (paper §6 future work).

The port of ``repro/core/distributed.py``.  The FSP inner loop is a
group-by-signature + count-distinct over the (entities x |SP|) object
matrix.  On a mesh:

* rows (entities) are split into equal blocks over the mesh's
  data-parallel axes, one block per DP coordinate, on that entry's
  device (:func:`shard_rows`);
* each shard hashes its rows with the ``sig_hash`` kernel, giving
  fixed-width 64-bit keys;
* :func:`ami_bucketed_batch` routes every signature once to its hash
  owner (one exchange), the owner sorts and segment-counts what it
  received with ``seg_count``, and the per-shard counts sum.

The JAX package runs the body under ``shard_map`` in one process; so
does the port, without ``shard_map``: one process loops over the DP
coordinates, each shard's tensors on its own device, and the exchange
moves slab ``j`` of every source shard to shard ``j``'s device.  Replicas
along a non-DP axis (``"model"``) would compute the same thing, so the
body runs once per DP coordinate.  On one card every device is the
same, and the exchange is a permutation on the card.
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

from ..kernels import ops as kops
from .star import ami_device, ami_device_batch, edges_formula_device
from .sweep import register_stats_reset
from .triples import TripleStore

# the exchange's accounting: ``calls`` counts ami_bucketed_batch calls,
# ``bytes`` the signature slabs every shard sends (its own slab
# included: ``n_shards^2 * C * cap * 8`` per call), ``dropped`` the
# signatures that overflowed a bucket (each adds one to the count)
EXCHANGE_STATS = {"calls": 0, "bytes": 0, "dropped": 0}


def reset_exchange_stats() -> None:
    for k in EXCHANGE_STATS:
        EXCHANGE_STATS[k] = 0


register_stats_reset(reset_exchange_stats)


def pad_rows(objmat: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the row count to a multiple of the DP degree (sentinel rows)."""
    n = objmat.shape[0]
    pad = (-n) % multiple
    if pad:
        sentinel = np.full((pad, objmat.shape[1]), -1, objmat.dtype)
        objmat = np.concatenate([objmat, sentinel], axis=0)
    return objmat, n


def _drop_one_keep(k: int) -> torch.Tensor:
    """(k, k-1) column indices: row j is every column but j."""
    return torch.tensor([[c for c in range(k) if c != j] for j in range(k)],
                        dtype=torch.int64)


def sweep_drop_one(objmat: torch.Tensor, valid: torch.Tensor, am, n_s: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate all |SP| one-property-removed candidate subsets at once.

    objmat: (n, k) int32; valid: (n,) bool (padding mask).
    Returns (edges (k,), amis (k,)) for candidate j = SP minus property j.
    """
    n, k = objmat.shape
    keep = _drop_one_keep(k).to(objmat.device)
    stacked = objmat[:, keep.T].permute(2, 0, 1).contiguous()  # (k, n, k-1)
    amis = ami_device_batch(stacked, valid=valid)
    return edges_formula_device(amis, am, k - 1, n_s), amis


def eval_subset_device(objmat: torch.Tensor, valid: torch.Tensor, am,
                       n_sp: int, n_s: int):
    a = ami_device(objmat, valid=valid)
    return edges_formula_device(a, am, n_sp, n_s), a


def dp_axes_of(mesh) -> tuple[str, ...]:
    """Every axis but ``"model"``: where rows shard by default."""
    return tuple(a for a in mesh.axis_names if a != "model")


def dp_devices(mesh, dp_axes: Sequence[str]) -> list[torch.device]:
    """The device of each DP coordinate, in the linear order of
    ``dp_axes`` (the first axis major), taken at index 0 of every other
    axis (the replicas there compute the same thing)."""
    names = list(mesh.axis_names)
    missing = [a for a in dp_axes if a not in names]
    if missing:
        raise ValueError(f"dp axes {missing} not in mesh axes {names}")
    order = [names.index(a) for a in dp_axes] + \
        [i for i, a in enumerate(names) if a not in dp_axes]
    devs = np.transpose(mesh.devices, order)
    devs = devs[(Ellipsis,) + (0,) * (len(names) - len(dp_axes))]
    return [devs[idx] for idx in itertools.product(
        *(range(s) for s in devs.shape))]


def _blocks(x, devices: list[torch.device], what: str) -> list:
    """``x`` split into one equal row block per device, each on its
    device; a list or tuple is taken as blocks already placed."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(devices):
            raise ValueError(f"{what}: {len(x)} shards for {len(devices)} "
                             "DP coordinates")
        return [t.to(d) for t, d in zip(x, devices)]
    t = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray)
                        else x)
    n = t.shape[0]
    if n % len(devices):
        raise ValueError(f"{what}: {n} rows do not split over "
                         f"{len(devices)} shards; pad them (pad_rows)")
    step = n // len(devices)
    return [t[i * step:(i + 1) * step].contiguous().to(d)
            for i, d in enumerate(devices)]


def shard_rows(objmat, mesh, dp_axes: Sequence[str] | None = None) -> list:
    """Place the object matrix row-sharded over the DP axes (every axis
    but ``"model"`` by default): one contiguous row block per DP
    coordinate, on its device."""
    axes = dp_axes_of(mesh) if dp_axes is None else tuple(dp_axes)
    return _blocks(objmat, dp_devices(mesh, axes), "shard_rows")


def gfsp_distributed(store: TripleStore, class_id: int, *, mesh=None,
                     device="cuda"):
    """Algorithm 2 (G.FSP) with the mesh-sharded device sweep.

    Equivalent to ``repro_torch.api.Compactor(detector="gfsp",
    backend="sharded", backend_opts={"mesh": mesh}).detect(store,
    class_id)``: the control flow is the shared ``GreedyDetector`` loop,
    so host / device / sharded results are identical by construction.
    ``device`` is where the sweep runs when ``mesh`` is ``None``."""
    from ..api import GreedyDetector, ShardedBackend

    backend = ShardedBackend(mesh=mesh, device=device)
    return GreedyDetector().detect(store, class_id, backend=backend)


def _route(mat: torch.Tensor, val: torch.Tensor, masks: torch.Tensor,
           n_shards: int, cap_factor: float):
    """One shard's half of the exchange: hash the masked candidates,
    bucket each signature by its owner ``hi % n_shards`` (invalid rows to
    the dump), and fill a ``(n_shards, C, cap, 2)`` int32 buffer of the
    kept signatures.  Returns the buffer and the (C,) count of
    signatures that overflowed their bucket."""
    nl, c, dev = mat.shape[0], masks.shape[0], mat.device
    # mask-aware signature: padding rows get the shared sentinel,
    # independently per candidate
    sig = kops.row_signature(mat, valid=val, col_masks=masks)  # (c, nl, 2)
    s32 = sig.view(torch.int32)
    # the owner of the unsigned hi lane, widened first: CUDA takes few
    # ops on uint32, and a signed view would take a signed remainder
    owner = (s32[..., 0].to(torch.int64) & 0xFFFFFFFF) % n_shards
    owner = torch.where(val[None, :], owner, n_shards)   # invalid -> dump
    cap = max(int(cap_factor * nl / n_shards) + 8, 8)
    # stable, as jnp.argsort is: which signatures overflow depends on it
    owner_s, order = torch.sort(owner, dim=1, stable=True)
    sig_s = torch.take_along_dim(s32, order[..., None], dim=1)
    firsts = torch.arange(n_shards, device=dev).expand(c, n_shards)
    starts = torch.searchsorted(owner_s, firsts.contiguous())
    pos = torch.arange(nl, device=dev)[None, :] - torch.take_along_dim(
        starts, owner_s.clamp(max=n_shards - 1), dim=1)
    live = owner_s < n_shards
    keep = live & (pos < cap)
    dropped = (live & (pos >= cap)).sum(dim=1)
    # cap + 1: slot ``cap`` is the dump slot for entries not kept --
    # dumping them at (0, 0) would overwrite a real signature
    buf = torch.full((n_shards, c, cap + 1, 2), -1, dtype=torch.int32,
                     device=dev)
    ci = torch.arange(c, device=dev)[:, None].expand(c, nl)
    buf[torch.where(keep, owner_s, 0), ci, torch.where(keep, pos, cap)] = \
        torch.where(keep[..., None], sig_s, -1)
    return buf[:, :, :cap], dropped


def ami_bucketed_batch(objmat, valid, col_masks, mesh, *,
                       dp_axes: Sequence[str] = ("data",),
                       cap_factor: float = 4.0) -> torch.Tensor:
    """Candidate-batched distinct-row count via ONE hash-bucket exchange.

    Every signature moves once: each shard routes its signatures to
    their hash owner with a static per-destination capacity (uniform
    murmur hashes make a 4x headroom overflow negligible, and overflow
    is counted and added, so an inexact count is observable), the owner
    dedups locally, and the per-shard counts sum.  The candidate axis
    rides the same schedule: all C column-mask candidates hash in one
    signature launch per shard, and every slab carries a candidate
    dimension.

    objmat: (n, k) int32 rows, split here into one block per DP
    coordinate (or the blocks :func:`shard_rows` placed); valid: (n,)
    bool (or its blocks); col_masks: (C, k) int32 column masks (1 = keep
    column), the same on every shard.  Returns (C,) int32, one AMI per
    candidate, on the first shard's device.
    """
    axes = tuple(dp_axes)
    devices = dp_devices(mesh, axes)
    n_shards = len(devices)
    mats = _blocks(objmat, devices, "objmat")
    vals = _blocks(valid, devices, "valid")
    masks = torch.as_tensor(np.ascontiguousarray(col_masks)
                            if isinstance(col_masks, np.ndarray)
                            else col_masks).to(torch.int32)
    c = masks.shape[0]
    sent, dropped = [], []
    for mat, val, dev in zip(mats, vals, devices):
        buf, drop = _route(mat, val, masks.to(dev), n_shards, cap_factor)
        sent.append(buf)
        dropped.append(drop)
    cap = sent[0].shape[2]
    EXCHANGE_STATS["calls"] += 1
    EXCHANGE_STATS["bytes"] += n_shards * n_shards * c * cap * 8
    # the exchange: shard j receives slab j of every source shard, the
    # sources in order along the row axis of each candidate
    out_dev = devices[0]
    total = torch.zeros((c,), dtype=torch.int32, device=out_dev)
    for j, dev in enumerate(devices):
        recv = torch.cat([buf[j].to(dev) for buf in sent], dim=1)
        sig_sorted, _ = kops.sort_signatures(recv.view(torch.uint32))
        _, n_groups = kops.seg_boundaries(sig_sorted)      # (c,)
        has_sent = (sig_sorted.view(torch.int32) == -1).all(dim=-1) \
            .any(dim=-1)
        total += (n_groups - has_sent.to(torch.int32)).to(out_dev)
    n_drop = torch.stack([d.to(out_dev) for d in dropped]).sum(dim=0)
    EXCHANGE_STATS["dropped"] += int(n_drop.sum())
    return total + n_drop.to(torch.int32)        # the upper-bound fix


def ami_bucketed(objmat, valid, mesh, *, dp_axes: Sequence[str] = ("data",),
                 cap_factor: float = 4.0) -> torch.Tensor:
    """Single-candidate distinct-row count: the C = 1 case of
    :func:`ami_bucketed_batch` with an all-ones column mask."""
    k = (objmat[0] if isinstance(objmat, (list, tuple)) else objmat).shape[1]
    masks = torch.ones((1, k), dtype=torch.int32)
    return ami_bucketed_batch(objmat, valid, masks, mesh, dp_axes=dp_axes,
                              cap_factor=cap_factor)[0]


__all__ = ["EXCHANGE_STATS", "pad_rows", "sweep_drop_one",
           "eval_subset_device", "dp_axes_of", "dp_devices", "shard_rows",
           "gfsp_distributed", "ami_bucketed_batch", "ami_bucketed",
           "reset_exchange_stats"]
