"""Median per op of the summed self time of the program's ``store.load`` spans
(convert.store_from_arrays: the dictionary from the terms and the row sort), in ms."""
from bench_port.program_spans import span_ms


def read(run):
    return span_ms(run, "store.load")
