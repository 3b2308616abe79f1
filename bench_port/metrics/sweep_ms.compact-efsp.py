"""Median per op of the summed self time of the program's ``sweep`` spans
(the workspaces' sweep_candidates: first upload, launches, copy back,
each candidate's entity set), in ms."""
from bench_port.program_spans import span_ms


def read(run):
    return span_ms(run, "sweep")
