"""``bench_port/program_spans.py`` on hand-built traces with known
answers: self times of nested spans, grouping by op, the rows-per-entity
ratio, device idle time put down to the innermost leaf span or to none,
and silence where the program has no recorder."""
import sys
import types
from typing import NamedTuple

import pytest

from bench_port import program_spans as ps
from bench_port.tracing import DeviceTrace

MS = 1_000_000


class Rec(NamedTuple):
    name: str
    span_id: int
    parent_id: int | None
    trace_id: int
    start_ns: int
    end_ns: int
    attrs: dict


def _op(base, ids):
    """One op's records from ``base`` ms on, ids from ``ids``: plan
    (0-10) holding detect (1-9) holding extract (2-4, with an
    index.build 2.5-3.5 inside) and sweep (5-8); execute (11-20)
    holding factorize (11-19) with rewrite (12-18)."""
    i = iter(ids)

    def rec(name, parent, s, e, **attrs):
        sid = next(i)
        trace = sid if parent is None else parent.trace_id
        return Rec(name, sid, None if parent is None else parent.span_id,
                   trace, (base + s) * MS, (base + e) * MS, attrs)
    plan = rec("plan", None, 0, 10)
    det = rec("detect", plan, 1, 9, class_id=2, am=100, n_s=5)
    ext = rec("extract", det, 2, 4, rows=100, cols=5)
    idx = rec("index.build", ext, 2.5, 3.5, rows=900)
    sw = rec("sweep", det, 5, 8, candidates=8)
    exe = rec("execute", None, 11, 20)
    fac = rec("factorize", exe, 11, 19, class_id=2)
    ext2 = rec("extract", fac, 11, 12, rows=200, cols=2)
    rw = rec("rewrite", fac, 12, 18, rows=700)
    return [plan, det, ext, idx, sw, exe, fac, ext2, rw]


OPS = [(0, 21 * MS), (30 * MS, 52 * MS)]
RECS = _op(0, range(1, 100)) + _op(30, range(100, 200))
# the second op is slower in its rewrite: 12-21 instead of 12-18
RECS[-1] = RECS[-1]._replace(end_ns=(30 + 21) * MS)
RECS[-4] = RECS[-4]._replace(end_ns=(30 + 21) * MS)   # execute
RECS[-3] = RECS[-3]._replace(end_ns=(30 + 21) * MS)   # factorize


def _run(device=(), recs=RECS, window=(0, 60 * MS)):
    trace = DeviceTrace(list(device), [(s, e, "op") for s, e in OPS]
                        + [(1 * MS, 9 * MS, "plan")], window)
    return types.SimpleNamespace(trace=trace), recs


@pytest.fixture
def recorded(monkeypatch):
    """The program's recorder returning the hand-built records."""
    from repro_torch import obs

    def use(recs):
        monkeypatch.setattr(obs, "records", lambda: list(recs))
    return use


def test_self_times_of_nested_spans():
    own = ps.self_ns(RECS[:9])
    by = {r.name + str(i): own[r.span_id] for i, r in enumerate(RECS[:9])}
    assert by["plan0"] == 2 * MS          # 10 - detect's 8
    assert by["detect1"] == 3 * MS        # 8 - extract 2 - sweep 3
    assert by["extract2"] == 1 * MS       # 2 - index.build 1
    assert by["index.build3"] == 1 * MS
    assert by["factorize6"] == 1 * MS     # 8 - extract 1 - rewrite 6
    assert by["rewrite8"] == 6 * MS


def test_records_are_grouped_by_the_op_holding_their_midpoint():
    stray = Rec("extract", 999, None, 999, 24 * MS, 26 * MS, {"rows": 5})
    groups = ps.group_by_op(RECS + [stray], OPS)
    assert [len(g) for g in groups] == [9, 9]
    assert {r.span_id for r in groups[0]} == set(range(1, 10))
    # a span straddling an op's start by less than half its length
    early = Rec("store.load", 998, None, 998, 29 * MS, 33 * MS, {})
    assert ps.group_by_op([early], OPS) == [[], [early]]


@pytest.mark.parametrize("name, want", [
    ("rewrite", (6 + 9) / 2),             # median of 6 and 9 ms
    ("extract", 1 + 1),                   # 1 ms in detect, 1 in factorize
    ("index.build", 1), ("sweep", 3),
    ("mint", None),                       # no op holds one
])
def test_span_ms_is_the_median_per_op_of_summed_self_time(
        recorded, name, want):
    run, recs = _run()
    recorded(recs)
    assert ps.span_ms(run, name) == want


def test_rows_per_entity(recorded):
    run, recs = _run()
    recorded(recs)
    # (100 + 200) extract rows over 100 entities of the one detect
    assert ps.extract_rows_per_entity(run) == pytest.approx(3.0)
    recorded([r for r in recs if r.name != "detect"])
    assert ps.extract_rows_per_entity(run) is None


def test_idle_time_goes_to_the_innermost_leaf_or_to_none(recorded):
    # the device is busy 5-8 ms (under op 1's sweep) and 40-60 ms
    run, recs = _run(device=[(5 * MS, 8 * MS, "k"), (40 * MS, 60 * MS, "k")])
    by = ps.idle_by_span(run.trace, recs)
    assert by == {
        "index.build": 2 * MS,            # 2.5-3.5 and 32.5-33.5
        "extract": 3 * MS,                # around them, and 11-12
        "sweep": 3 * MS,                  # op 2's 35-38; op 1's was busy
        "rewrite": 6 * MS,                # op 1's; op 2's ran busy
        None: 23 * MS,                    # 0-2 4-5 8-11 18-32 34-35 38-40
    }
    assert sum(by.values()) == (60 - 3 - 20) * MS
    recorded(recs)
    assert ps.idle_unattributed_pct(run) == pytest.approx(100 * 23 / 37)


def test_every_reader_is_silent_without_the_recorder(monkeypatch):
    import repro_torch
    run, _ = _run()
    # the program as it was before it had one
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert ps.program_records(run) is None
    assert ps.span_ms(run, "extract") is None
    assert ps.extract_rows_per_entity(run) is None
    assert ps.idle_unattributed_pct(run) is None


def test_an_untraced_run_reads_nothing():
    assert ps.span_ms(types.SimpleNamespace(trace=None), "extract") is None
