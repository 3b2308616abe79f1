"""Distribution substrate of the port: device meshes (:mod:`mesh`), the
sharding planner (:mod:`sharding`: logical axes to mesh axes, the batch
ladder), elastic re-meshing (:mod:`elastic`), the sharded factorized
graph with its fan-out query engine (:mod:`graph`), fault detection and
injection for the online compaction service (:mod:`fault`), and int8
gradient compression (:mod:`compression`)."""
from . import compression, elastic, fault, graph, mesh, sharding  # noqa: F401
