"""Compaction API: pluggable detectors x execution backends over a
snapshot-holding ``Compactor``:

    from repro_torch.api import Compactor

    comp = Compactor(detector="gfsp", backend="device")   # runs on CUDA
    report = comp.run(store)

* detectors -- ``gfsp`` (greedy, Alg. 2), ``efsp`` (exhaustive, Alg. 1),
  ``gspan`` (mined-pattern-space baseline).
* execution backends -- ``host`` (numpy), ``device`` (batched torch on
  ``device``, default ``"cuda"``).
"""
from .backends import (BACKENDS, DeviceBackend, ExecutionBackend,  # noqa: F401
                       HostBackend, get_backend)
from .detectors import (DETECTORS, Detector, ExhaustiveDetector,  # noqa: F401
                        GreedyDetector, GSpanBaseline, get_detector)
from .snapshot import (ClassPlan, CompactionPlan, CompactionPlanner,  # noqa: F401
                       CompactionReport, GraphSnapshot)
from .compactor import Compactor  # noqa: F401
