"""Factorized corpus store: the paper's compaction on the data plane.

The port's copy of ``repro/data/factorized_store.py`` (numpy, over the
port's ``core.star.row_groups``).  Exactly repeated rows of a token
corpus are an RDF-graph-shaped object (entity = row, property = token
position, object = token id, star pattern = a distinct row):
``FactorizedStore`` keeps each distinct row once as a molecule and each
original row an ``instanceOf`` pointer, unless that takes more bytes
than the rows themselves (the paper's Fig. 7 overhead case: stored
flat).  A read is a gather; :meth:`FactorizedStore.batch` with a device
ships each distinct molecule of the batch once and expands the pointers
there with torch.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.star import row_groups


@dataclasses.dataclass
class FactorizedStore:
    molecules: np.ndarray | None      # (M, L) unique rows (None: flat)
    instance_of: np.ndarray | None    # (N,) row -> molecule
    flat: np.ndarray | None           # unfactorized fallback
    bytes_original: int
    bytes_stored: int

    @classmethod
    def build(cls, rows: np.ndarray, ptr_bytes: int = 4) -> "FactorizedStore":
        rows = np.asarray(rows)
        n, length = rows.shape
        item = rows.dtype.itemsize
        original = n * length * item
        inv, counts, rep = row_groups(rows)
        m = counts.shape[0]
        factorized = m * length * item + n * ptr_bytes
        if factorized >= original:                  # overhead case (Fig. 7)
            return cls(None, None, rows, original, original)
        return cls(rows[rep], inv.astype(np.int32), None, original,
                   factorized)

    @property
    def savings_pct(self) -> float:
        return 100.0 * (1 - self.bytes_stored / max(self.bytes_original, 1))

    @property
    def n_rows(self) -> int:
        if self.flat is not None:
            return self.flat.shape[0]
        return self.instance_of.shape[0]

    def __getitem__(self, idx) -> np.ndarray:
        if self.flat is not None:
            return self.flat[idx]
        return self.molecules[self.instance_of[idx]]

    def batch_parts(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``(unique_molecules, inverse)`` of a batch gather:
        ``unique_molecules[inverse]`` is the batch, and the first part is
        the whole host-to-device payload (a flat store: every row its own
        molecule)."""
        idx = np.asarray(idx)
        if self.flat is not None:
            rows = self.flat[idx].reshape(-1, self.flat.shape[1])
            return rows, np.arange(rows.shape[0]).reshape(idx.shape)
        mol = self.instance_of[idx]
        uniq, inv = np.unique(mol, return_inverse=True)
        return self.molecules[uniq], inv.reshape(mol.shape)

    def batch(self, idx: np.ndarray, device=False):
        """The batch's rows.  ``device``: False for a numpy gather on the
        host; True (``cuda``) or a torch device to send the unique
        molecules there once and expand the pointers there (a torch
        tensor)."""
        mols, inv = self.batch_parts(idx)
        if device is False:
            return mols[inv]
        import torch

        from ..kernels.ops import resolve_device
        dev = resolve_device("cuda" if device is True else device)
        return torch.from_numpy(np.ascontiguousarray(mols)).to(dev)[
            torch.from_numpy(np.asarray(inv, np.int64)).to(dev)]
