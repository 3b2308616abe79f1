"""Median per op of the summed self time of the program's ``extract`` spans
(GraphIndex.object_matrix: the object-matrix joins), in ms."""
from bench_port.program_spans import span_ms


def read(run):
    return span_ms(run, "extract")
