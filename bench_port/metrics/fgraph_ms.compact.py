"""Median per op of the summed self time of the program's ``fgraph.build`` spans
(FactorizedGraph.from_compaction), in ms."""
from bench_port.program_spans import span_ms


def read(run):
    return span_ms(run, "fgraph.build")
