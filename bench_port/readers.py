"""Shared arithmetic of the per-layer readers in ``metrics/``: each reader
is a file of its own that calls one of these with what it reads."""
from __future__ import annotations

import statistics

from .ref.work import SigLaunch, seg_count_bound_s, sig_hash_bound_s


def span_median_ms(run, name: str) -> float | None:
    """Median of a benchmark span, in ms (None where it never ran)."""
    s = run.spans.seconds.get(name)
    return statistics.median(s) * 1e3 if s else None


def idle_pct(run) -> float | None:
    """The traced window's share in which no operation ran on the card."""
    t = run.trace
    if t is None or t.window_seconds <= 0:
        return None
    return 100.0 * (1.0 - t.busy_seconds() / t.window_seconds)


def roofline_pct(run, kernel: str) -> float | None:
    """The bound of every launch of ``kernel`` in the traced window, from
    the benchmark's own work count of its true sizes, over the kernel
    time the profiler summed; None where the launches the benchmark
    recorded and those the profiler saw do not pair up one to one."""
    t, args = run.trace, run.kernel_args
    if t is None or args is None:
        return None
    secs, n = t.kernel_seconds(f"{kernel}_kernel")
    sig = args.launches()
    if kernel == "sig_hash":
        if n == 0 or n != len(sig):
            return None
        bound = sum(sig_hash_bound_s(SigLaunch(*w)) for w in sig)
    else:
        if n == 0 or n != len(args.seg):
            return None
        bound = sum(seg_count_bound_s(sig[i][0], len(sig[i][1]))
                    for i in args.seg)
    return 100.0 * bound / secs if secs > 0 else None
