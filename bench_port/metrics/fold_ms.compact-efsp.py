"""Median per op of the summed self time of the program's ``fold`` spans
(the planner's fold-once pass over the ranked classes), in ms."""
from bench_port.program_spans import span_ms


def read(run):
    return span_ms(run, "fold")
