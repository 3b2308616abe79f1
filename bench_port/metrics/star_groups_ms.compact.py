"""Median per op of the summed self time of the program's ``star_groups`` spans
(star_groups: one tuple per star pattern), in ms."""
from bench_port.program_spans import span_ms


def read(run):
    return span_ms(run, "star_groups")
