"""Median per op of the benchmark's span around Compactor.execute (factorization and substrate), in ms."""
from bench_port.readers import span_median_ms


def read(run):
    return span_median_ms(run, "execute")
