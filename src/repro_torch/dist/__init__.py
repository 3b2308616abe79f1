"""Distribution substrate of the port: device meshes (:mod:`mesh`), the
sharding planner's batch-axis rules (:mod:`sharding`), the sharded
factorized graph with its fan-out query engine (:mod:`graph`), fault
detection and injection for the online compaction service
(:mod:`fault`), and int8 gradient compression (:mod:`compression`).
Elastic re-meshing waits for a later slice."""
from . import compression, fault, graph, mesh, sharding  # noqa: F401
