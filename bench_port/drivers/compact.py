"""Closed-loop compaction: whole ``Compactor(detector, "device")`` ops
back to back, each on a fresh store over the raw rows of a graph from a pool
made in set-up from the seed.

The driver is schema-free: it takes its graphs from the generator the
configuration names (``run.gen``, ``gen/__init__.py`` states its
contract), so any generator that keeps that contract runs through the
same op, reference and check.

Mix numbers: ``pool`` (graphs), ``check_ops`` (ops the reference judges,
drawn from the seed among those the window completed), and optionally
``detector`` (``"gfsp"``, the default, or ``"efsp"``: the program's
detector and the reference's algorithm alike).

``compact_triples_per_s`` is the input triples of every op the window
completed over the window's wall time; the window runs whole ops until
``--seconds`` have passed and ends when the op in flight does.  Each op
is ``convert.store_from_arrays`` then ``plan`` and ``execute`` (what
``Compactor.run`` calls), spanned apart.
"""
from __future__ import annotations

import functools
import resource
import sys
import time

import numpy as np

from ..ref import fsp
from ..ref.graph import Graph, rows_diff, sort_unique


def _program_op(terms, spo, device, spans, detector="gfsp"):
    from repro_torch.api import Compactor
    from repro_torch.convert import store_from_arrays
    store = store_from_arrays(terms, spo)
    comp = Compactor(detector, "device", backend_opts={"device": device})
    with spans("plan"):
        plan = comp.plan(store)
    with spans("execute"):
        rep = comp.execute(store, plan)
    rows = [(e.class_id, tuple(e.props), e.detection.edges, e.detection.ami,
             e.detection.evaluations, e.detection.iterations,
             e.predicted_edges, e.baseline_edges) for e in rep.plan]
    tables = {cid: (t.props, t.surrogates, t.objects)
              for cid, t in rep.fgraph.tables.items()}
    return rows, rep.graph.spo, tables


def _reference(terms, spo, sig_bits=64, detector="gfsp"):
    """(plan rows, G' rows, tables) as the plain reference works them out
    with ``detector``'s algorithm."""
    g = Graph(spo, type_id=0)
    entries = fsp.plan(g, inst_id=1, sig_bits=sig_bits, detector=detector)
    gp, tables = fsp.factorize(spo, entries, len(terms), 0, 1, sig_bits)
    rows = [(e.class_id, e.props, e.edges, e.ami, e.evaluations,
             e.iterations, e.predicted_edges, e.baseline_edges)
            for e in entries]
    return rows, gp, {c: (t.props, t.surrogates, t.objects)
                      for c, t in tables.items()}


def _control_op(terms, spo, device, spans, detector="gfsp"):
    """The control: the reference with molecules grouped by a 16-bit row
    hash, in the program's place (``ref/fsp.py``)."""
    with spans("plan"):
        pass
    with spans("execute"):
        return _reference(terms, spo, sig_bits=16, detector=detector)


def mix_detector(run) -> str:
    """The detector the mix names, ``gfsp`` where it names none."""
    return str(run.traffic.get("detector", "gfsp"))


def setup(run):
    vocab = run.gen.Vocabulary(run.spec)
    pool = [run.gen.graph_rows(vocab, run.spec, run.rng(1, j))
            for j in range(int(run.traffic["pool"]))]
    op = functools.partial(_control_op if run.control else _program_op,
                           detector=mix_detector(run))
    op(vocab.terms, pool[0], run.device, run.spans)     # warm every shape
    run.spans.seconds.clear()
    return {"vocab": vocab, "pool": pool, "op": op, "outs": []}


def window(run, state):
    terms, pool, outs = state["vocab"].terms, state["pool"], state["outs"]
    triples = 0
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    while True:
        j = len(outs) % len(pool)
        run.attempted += 1
        with run.spans("op"):
            outs.append((j, state["op"](terms, pool[j], run.device,
                                         run.spans)))
        triples += pool[j].shape[0]
        if time.perf_counter() - t0 >= run.seconds:
            break
    wall = time.perf_counter() - t0
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    run.e2e["compact_triples_per_s"] = triples / wall
    sp = run.spans.seconds
    print(f"bench_port {run.name}: {len(outs)} ops in {wall:.3f} s; op s "
          f"{[round(x, 3) for x in sp['op']]}, plan s "
          f"{[round(x, 3) for x in sp['plan']]}, execute s "
          f"{[round(x, 3) for x in sp['execute']]}; process user "
          f"{r1.ru_utime - r0.ru_utime:.3f} s, sys "
          f"{r1.ru_stime - r0.ru_stime:.3f} s, minor faults "
          f"{r1.ru_minflt - r0.ru_minflt}, involuntary switches "
          f"{r1.ru_nivcsw - r0.ru_nivcsw}", file=sys.stderr)


def release(run, state):
    """Nothing to free: each op's ``Compactor`` went with the op, and its
    outputs are what the check judges."""


def _plan_diff(got, want) -> int:
    """Differing fields of two plans (a missing or extra entry counts all
    eight)."""
    n = 8 * abs(len(got) - len(want))
    for a, b in zip(got, want):
        n += sum(x != y for x, y in zip(a, b))
    return n


def _table_diff(got, want) -> int:
    """Differing molecules of two sets of tables (classes, props,
    surrogate ids and object rows)."""
    n = 0
    for cid in set(got) | set(want):
        if cid not in got or cid not in want:
            n += len((got.get(cid) or want.get(cid))[1])
            continue
        (pa, sa, oa), (pb, sb, ob) = got[cid], want[cid]
        if tuple(pa) != tuple(pb) or len(sa) != len(sb):
            n += max(len(sa), len(sb))
            continue
        n += int(((np.asarray(sa) != np.asarray(sb))
                  | (np.asarray(oa) != np.asarray(ob)).any(axis=1)).sum())
    return n


def check(run, state):
    """Every op the window completed, or ``check_ops`` of them drawn from
    the seed, against the reference on the same graph: the plan (each
    class's SP, AMI, #Edges, evaluations, iterations, predictions), the
    G' rows, the molecule tables, and losslessness (the reference's
    expansion of the op's G' against the input)."""
    outs = state["outs"]
    k = min(int(run.traffic["check_ops"]), len(outs))
    pick = sorted(run.rng(2).choice(len(outs), k, replace=False).tolist())
    terms, pool = state["vocab"].terms, state["pool"]
    refs: dict[int, tuple] = {}
    plan_d = gp_d = tab_d = loss_d = 0
    for i in pick:
        j, (rows, gp, tables) = outs[i]
        if j not in refs:
            refs[j] = _reference(terms, pool[j], detector=mix_detector(run))
        r_rows, r_gp, r_tables = refs[j]
        plan_d += _plan_diff(rows, r_rows)
        gp_d += rows_diff(sort_unique(gp), r_gp)
        tab_d += _table_diff(tables, r_tables)
        loss_d += rows_diff(fsp.expand(gp, 0, 1), sort_unique(pool[j]))
    return [("plan_fields_wrong", plan_d, 0), ("gprime_rows_wrong", gp_d, 0),
            ("molecules_wrong", tab_d, 0), ("rows_lost_or_added", loss_d, 0),
            ("ops_checked_missing", max(1 - len(pick), 0), 0)]
