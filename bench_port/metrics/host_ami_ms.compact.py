"""Median per op of the summed self time of the program's ``ami.host`` spans
(the sweep workspace's exact host AMI (evaluate_current)), in ms."""
from bench_port.program_spans import span_ms


def read(run):
    return span_ms(run, "ami.host")
