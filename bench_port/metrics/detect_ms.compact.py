"""Median per op of the benchmark's span around Compactor.plan (detection: planner, detectors, sweep, kernels), in ms."""
from bench_port.readers import span_median_ms


def read(run):
    return span_median_ms(run, "plan")
