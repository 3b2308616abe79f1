"""Median per op of the summed self time of the program's ``index.build`` spans
(TripleStore.index: the lazy GraphIndex builds), in ms."""
from bench_port.program_spans import span_ms


def read(run):
    return span_ms(run, "index.build")
