"""Median per op of the summed self time of the program's ``rewrite`` spans
(apply_molecule_map and the sort of G'), in ms."""
from bench_port.program_spans import span_ms


def read(run):
    return span_ms(run, "rewrite")
