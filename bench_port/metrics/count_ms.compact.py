"""Median per op of the summed self time of the program's ``count`` spans
(_class_nle_nodes: the class's labeled edges and nodes), in ms."""
from bench_port.program_spans import span_ms


def read(run):
    return span_ms(run, "count")
