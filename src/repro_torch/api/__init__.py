"""Compaction API: pluggable detectors x execution backends over a
snapshot-holding ``Compactor``:

    from repro_torch.api import Compactor

    comp = Compactor(detector="gfsp", backend="device")   # runs on CUDA
    report = comp.run(store)           # rank classes, factorize the winners
    comp.update(new_triples)           # absorb streaming inserts

* detectors -- ``gfsp`` (greedy, Alg. 2), ``efsp`` (exhaustive, Alg. 1),
  ``gspan`` (mined-pattern-space baseline); ``register_detector`` adds
  more.
* execution backends -- ``host`` (numpy), ``device`` (batched torch on
  ``device``, default ``"cuda"``), ``sharded`` (rows sharded over a
  ``dist.mesh`` mesh, one hash-bucket exchange per sweep);
  ``register_backend`` adds more.
"""
from .backends import (BACKENDS, DeviceBackend, ExecutionBackend,  # noqa: F401
                       HostBackend, Registry, ShardedBackend, get_backend,
                       register_backend)
from .detectors import (DETECTORS, Detector, ExhaustiveDetector,  # noqa: F401
                        GreedyDetector, GSpanBaseline, get_detector,
                        register_detector)
from .snapshot import (ClassPlan, CompactionPlan, CompactionPlanner,  # noqa: F401
                       CompactionReport, DeleteReport, GraphSnapshot,
                       RedetectReport, UpdateReport)
from .compactor import Compactor  # noqa: F401
