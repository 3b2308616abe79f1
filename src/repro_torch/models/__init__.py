"""The LM substrate: blocks (attention, MLP, RG-LRU, SSD) and the ``LM``."""
from .lm import LM  # noqa: F401
