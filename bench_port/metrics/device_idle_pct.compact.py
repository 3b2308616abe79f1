"""The traced window's share with no operation on the card, in %."""
from bench_port.readers import idle_pct


def read(run):
    return idle_pct(run)
