"""Per-class support-drift tracking: WHICH classes deserve re-detection.

Def. 4.8 makes payoff a live quantity.  Two decay modes matter online:

* **raw residue growth** -- inserts land entities whose object tuples
  do not match any existing molecule (they stay raw, or mint fresh
  low-support surrogates).  The class's raw-typed population grows past
  the compacted baseline, which is exactly the signal that a *new*
  frequent star pattern may have emerged (or the old SP stopped being
  the best one).
* **support drift from deletes** -- membership exits, payoff-sweep
  decompactions and invalidated molecules shrink AMI/AM and push
  molecules toward the Fig. 7 overhead regime.

Both are tracked *incrementally*: update deltas (``UpdateReport.
per_class``) and delete deltas (``DeleteStats.per_class``) accumulate
into per-class counters, and the raw residue is one cached index probe
per touched class (``entities_of_class`` minus the class's molecule
count -- absorbed entities carry no direct ``type`` edge, so the
difference IS the raw population).  ``dirty_classes`` never scans
triples and never touches untouched classes; the re-detection loop it
feeds re-evaluates ONLY what it returns.
"""
from __future__ import annotations

from ..core.fgraph import DeleteStats, FactorizedGraph


def raw_residue(fg: FactorizedGraph, class_id: int) -> int:
    """Raw-typed entity count of a class in G': entities still carrying
    a direct ``type`` edge (surrogates included; members excluded --
    their type edge moved to the molecule), minus the molecule count."""
    cid = int(class_id)
    n = int(fg.store.entities_of_class(cid).shape[0])
    t = fg.tables.get(cid)
    return n - (t.n_molecules if t is not None else 0)


class DriftTracker:
    """Accumulates per-class drift and decides the dirty set.

    A class is *dirty* when, since its last (re-)detection:

    * its raw residue grew by >= ``raw_residue_threshold`` entities, or
    * its accumulated support-drift count (membership exits +
      decompacted entities + removed molecules + online-minted
      surrogates, which start life at the sub-payoff end) reached
      ``support_drift_threshold``.

    ``prime`` captures baselines from a fresh snapshot;
    ``note_redetected`` re-baselines exactly the classes a redetect pass
    considered, so drift in other classes keeps accumulating.

    A class whose re-detection keeps landing on a hill-climb-rejected
    plan (the realized-edges guard in ``CompactionPlanner.redetect``)
    **backs off exponentially**: each rejection doubles its effective
    thresholds (capped at ``2**max_backoff``), so the service stops
    paying a full sweep every pass for a class whose drift pattern keeps
    proposing the same regressive re-plan.  An accepted re-detection
    resets the backoff to zero.
    """

    def __init__(self, *, raw_residue_threshold: int = 8,
                 support_drift_threshold: int = 4,
                 max_backoff: int = 6) -> None:
        self.raw_residue_threshold = int(raw_residue_threshold)
        self.support_drift_threshold = int(support_drift_threshold)
        self.max_backoff = int(max_backoff)
        self._baseline: dict[int, int] = {}      # cid -> residue at detect
        self._support_drift: dict[int, int] = {}  # cid -> accumulated decay
        self._touched: set[int] = set()           # cids edited since prime
        self._backoff: dict[int, int] = {}        # cid -> rejection count

    # -- lifecycle ---------------------------------------------------------
    def prime(self, fg: FactorizedGraph) -> None:
        """Baseline every class of a freshly detected snapshot."""
        self._baseline = {int(c): raw_residue(fg, int(c))
                          for c in fg.store.classes().tolist()}
        self._support_drift = {}
        self._touched = set()

    def note_redetected(self, fg: FactorizedGraph, class_ids,
                        rejected: bool = False) -> None:
        """Re-baseline the classes a redetect pass just considered.

        ``rejected=True`` marks a pass the realized-edges hill-climb
        guard refused: the classes' backoff levels increment (their
        effective thresholds double, up to ``2**max_backoff``), so a
        class that keeps proposing a regressive re-plan must accumulate
        exponentially more drift before being re-evaluated.  An accepted
        pass resets the backoff."""
        for c in class_ids:
            cid = int(c)
            self._baseline[cid] = raw_residue(fg, cid)
            self._support_drift.pop(cid, None)
            self._touched.discard(cid)
            if rejected:
                self._backoff[cid] = min(self._backoff.get(cid, 0) + 1,
                                         self.max_backoff)
            else:
                self._backoff.pop(cid, None)

    def state_dict(self) -> dict:
        """JSON-serializable counter state (for checkpoints).  Residue
        baselines are part of the re-detection decision, so recovery
        must restore them exactly or the replayed drift decisions -- and
        with them the recovered digest -- could diverge."""
        return {
            "baseline": {str(k): v for k, v in self._baseline.items()},
            "support_drift": {str(k): v
                              for k, v in self._support_drift.items()},
            "touched": sorted(self._touched),
            "backoff": {str(k): v for k, v in self._backoff.items()},
        }

    def load_state(self, state: dict) -> None:
        self._baseline = {int(k): int(v)
                          for k, v in state["baseline"].items()}
        self._support_drift = {int(k): int(v)
                               for k, v in state["support_drift"].items()}
        self._touched = {int(c) for c in state["touched"]}
        self._backoff = {int(k): int(v)
                         for k, v in state["backoff"].items()}

    # -- incremental feeds -------------------------------------------------
    def observe_update(self, report) -> None:
        """Fold one ``UpdateReport`` in: touched classes join the watch
        set; online-minted surrogates count toward support drift (they
        start at the sub-payoff end until later batches reuse them)."""
        for cid in report.touched_classes:
            self._touched.add(int(cid))
        for cid, d in report.per_class.items():
            self._touched.add(int(cid))
            n = int(d.get("new_surrogates", 0))
            if n:
                self._support_drift[int(cid)] = \
                    self._support_drift.get(int(cid), 0) + n

    def observe_delete(self, stats: DeleteStats) -> None:
        """Fold one ``DeleteStats`` in: exits, decompactions and removed
        molecules all witness support decay of their class."""
        for cid, d in stats.per_class.items():
            n = int(d.get("exits", 0)) + int(d.get("decompacted", 0)) \
                + int(d.get("molecules_removed", 0))
            if n:
                cid = int(cid)
                self._touched.add(cid)
                self._support_drift[cid] = \
                    self._support_drift.get(cid, 0) + n

    # -- the decision ------------------------------------------------------
    def support_drift(self, class_id: int) -> int:
        return self._support_drift.get(int(class_id), 0)

    def residue_growth(self, fg: FactorizedGraph, class_id: int) -> int:
        cid = int(class_id)
        return raw_residue(fg, cid) - self._baseline.get(cid, 0)

    def backoff(self, class_id: int) -> int:
        """Consecutive rejected re-detections of a class (capped)."""
        return self._backoff.get(int(class_id), 0)

    def dirty_classes(self, fg: FactorizedGraph) -> list[int]:
        """Classes whose accumulated drift crossed a threshold -- the
        ONLY classes the re-detection loop will re-evaluate.  Probes
        touched classes exclusively (cached index lookups), so the check
        itself is proportional to the edited set, not the graph.
        Per-class thresholds scale by ``2**backoff``: repeatedly
        rejected classes need exponentially more drift to go dirty."""
        dirty = []
        for cid in sorted(self._touched):
            scale = 1 << self.backoff(cid)
            if self.support_drift(cid) \
                    >= self.support_drift_threshold * scale \
                    or self.residue_growth(fg, cid) \
                    >= self.raw_residue_threshold * scale:
                dirty.append(cid)
        return dirty
