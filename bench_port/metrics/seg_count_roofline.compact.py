"""seg_count's share of its roofline over the traced window's launches, in %."""
from bench_port.readers import roofline_pct


def read(run):
    return roofline_pct(run, "seg_count")
