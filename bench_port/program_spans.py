"""The program's own spans (``repro_torch.obs``) reduced to per-layer
numbers: shared arithmetic of the span readers in ``metrics/``.

A traced window turns the program's recorder on (it records whenever a
``torch.profiler`` does), and its records share the profiler's clock
(ns since the epoch).  Each record is put in the benchmark ``op`` span
(``run.trace.spans``) that holds its midpoint; a span's self time is its
duration less the part its child spans cover.  Device idle time is put
down to the innermost leaf span open at the time, or to none.

A program without the recorder leaves no records: every reader then
returns None.
"""
from __future__ import annotations

import bisect
import statistics

# the spans that do the work (the others, plan/detect/execute/factorize,
# only hold them); each has a ``<name>_ms``-style reader of its self time
LEAVES = ("store.load", "index.build", "extract", "ami.host", "sweep",
          "star_groups", "count", "mint", "rewrite", "fgraph.build")


def program_records(run):
    """The program's span records, or None where the program has no
    recorder or the run was not traced."""
    if run.trace is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.records()


def op_intervals(trace) -> list[tuple[int, int]]:
    """The benchmark's ``op`` spans, in time order."""
    return sorted((s, e) for s, e, n in trace.spans if n == "op")


def group_by_op(records, ops) -> list[list]:
    """The records of each op: those whose midpoint lies in it."""
    starts = [s for s, _ in ops]
    out: list[list] = [[] for _ in ops]
    for r in records:
        mid = (r.start_ns + r.end_ns) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= ops[i][1]:
            out[i].append(r)
    return out


def self_ns(records) -> dict[int, int]:
    """Span id -> duration less the part covered by its children."""
    covered: dict[int, int] = {}
    for r in records:
        if r.parent_id is not None:
            covered[r.parent_id] = (covered.get(r.parent_id, 0)
                                    + r.end_ns - r.start_ns)
    return {r.span_id: max(r.end_ns - r.start_ns
                           - covered.get(r.span_id, 0), 0)
            for r in records}


def _per_op(run):
    recs = program_records(run)
    return group_by_op(recs, op_intervals(run.trace)) if recs else None


def span_ms(run, name: str) -> float | None:
    """Median over ops of the summed self time of ``name``, in ms; None
    where no op holds such a span."""
    groups = _per_op(run)
    if not groups or not any(r.name == name for g in groups for r in g):
        return None
    per_op = []
    for g in groups:
        own = self_ns(g)
        per_op.append(sum(own[r.span_id] for r in g if r.name == name))
    return statistics.median(per_op) / 1e6


def extract_rows_per_entity(run) -> float | None:
    """Median over ops of the rows of every ``extract`` over the
    entities (``am``) of every ``detect``."""
    per_op = []
    for g in _per_op(run) or ():
        am = sum(r.attrs.get("am", 0) for r in g if r.name == "detect")
        if am:
            per_op.append(sum(r.attrs.get("rows", 0) for r in g
                              if r.name == "extract") / am)
    return statistics.median(per_op) if per_op else None


def idle_intervals(trace) -> list[tuple[int, int]]:
    """The window less the union of device activity."""
    lo, hi = trace.window_ns
    out, t = [], lo
    for s, e in trace.busy_intervals():
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def idle_by_span(trace, records) -> dict:
    """Device idle ns of the window by the innermost leaf span open at
    the time (the one opened last); the key ``None`` holds the idle time
    with no leaf span open."""
    idle = idle_intervals(trace)
    lo, hi = trace.window_ns
    spans = [r for r in records
             if r.name in LEAVES and r.end_ns > r.start_ns]
    # every piece between two cuts is all idle or all busy, and has one
    # set of open spans
    cuts = sorted({t for s, e in idle for t in (s, e)}
                  | {min(max(t, lo), hi) for r in spans
                     for t in (r.start_ns, r.end_ns)})
    # (time, 0 close | 1 open, span): closes first at a shared time
    events = sorted([(r.start_ns, 1, i) for i, r in enumerate(spans)]
                    + [(r.end_ns, 0, i) for i, r in enumerate(spans)])
    idle_starts = [s for s, _ in idle]
    live: dict[int, int] = {}             # open span -> its start
    out: dict = {}
    j = 0
    for a, b in zip(cuts, cuts[1:]):
        while j < len(events) and events[j][0] <= a:
            t, opens, i = events[j]
            if opens:
                live[i] = t
            else:
                live.pop(i, None)
            j += 1
        k = bisect.bisect_right(idle_starts, a) - 1
        if k < 0 or b > idle[k][1]:
            continue                          # the device was busy
        inner = max(live, key=live.get) if live else None
        key = spans[inner].name if inner is not None else None
        out[key] = out.get(key, 0) + (b - a)
    return out


def idle_unattributed_pct(run) -> float | None:
    """Share of the window's device idle time during which no leaf span
    of the program was open, in %."""
    recs = program_records(run)
    if not recs:
        return None
    by = idle_by_span(run.trace, recs)
    total = sum(by.values())
    return 100.0 * by.get(None, 0) / total if total else None
