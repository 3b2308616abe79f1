"""The traced window's device idle time with no leaf span of the program
open, as a share of all its device idle time, in %."""
from bench_port.program_spans import idle_unattributed_pct


def read(run):
    return idle_unattributed_pct(run)
