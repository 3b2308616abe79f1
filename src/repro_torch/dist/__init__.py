"""Fault detection and injection for the online compaction service
(:mod:`~repro_torch.dist.fault`).  The sharded substrate of the JAX
package (sharding plans, the sharded graph) is a later slice of the
port, so this package holds ``fault`` alone."""
from . import fault  # noqa: F401
