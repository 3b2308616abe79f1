"""Checkpoints of the port's train state (async, atomic, retained)."""
from .checkpoint import Checkpointer, latest_step  # noqa: F401
