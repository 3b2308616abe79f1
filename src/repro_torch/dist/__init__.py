"""Distribution substrate of the port: device meshes (:mod:`mesh`), the
sharding planner's batch-axis rules (:mod:`sharding`), the sharded
factorized graph with its fan-out query engine (:mod:`graph`), and fault
detection and injection for the online compaction service
(:mod:`fault`).  Gradient compression and elastic re-meshing wait for
the training slice."""
from . import fault, graph, mesh, sharding  # noqa: F401
