"""Median per op of the summed self time of the program's ``mint`` spans
(_factorize's surrogate minting: row groups, names, ids, mu), in ms."""
from bench_port.program_spans import span_ms


def read(run):
    return span_ms(run, "mint")
