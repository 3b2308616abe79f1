"""Synthetic LinkedSensorData-style RDF graphs (paper §5 datasets).

The paper evaluates on LinkedSensorData (SSN ontology): weather observations
with ``property / procedure / generatedBy / time`` edges and linked
measurements with ``value / unit`` edges.  The original dumps are not
redistributable offline, so this module regenerates graphs with the same
schema, the same A1-A10 property sets, and matched repetition statistics:

  * ``procedure``/``generatedBy`` are symmetric (same sensor object);
  * measurement values follow a Zipf law, so a few values are highly
    repeated (paper Fig. 8);
  * ``unit`` is functionally determined by the phenomenon (9 phenomena).

Scale is controlled by ``n_observations``; per-class property sets mirror
Table 2 (A1..A7 for Observation, A8..A10 for Measurement).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.triples import TripleStore

PHENOMENA = ["Temperature", "WindSpeed", "WindDirection", "RelativeHumidity",
             "Visibility", "Precipitation", "Pressure", "Rainfall", "Snowfall"]

OBSERVATION = "ssn:Observation"
MEASUREMENT = "ssn:Measurement"
SENSOR = "ssn:Sensor"
P_PROPERTY = "ssn:observedProperty"
P_PROCEDURE = "ssn:procedure"
P_GENERATED_BY = "ssn:generatedBy"
P_TIME = "ssn:samplingTime"
P_RESULT = "ssn:observationResult"
P_VALUE = "ssn:value"
P_UNIT = "ssn:unit"
P_MODEL = "ssn:model"
P_LOCATION = "ssn:location"

# Table 2 property sets
PROPERTY_SETS = {
    "A1": (OBSERVATION, [P_PROPERTY]),
    "A2": (OBSERVATION, [P_TIME]),
    "A3": (OBSERVATION, [P_PROCEDURE, P_GENERATED_BY]),
    "A4": (OBSERVATION, [P_PROPERTY, P_PROCEDURE, P_GENERATED_BY, P_TIME]),
    "A5": (OBSERVATION, [P_PROPERTY, P_PROCEDURE, P_GENERATED_BY]),
    "A6": (OBSERVATION, [P_PROPERTY, P_TIME]),
    "A7": (OBSERVATION, [P_PROCEDURE, P_TIME, P_GENERATED_BY]),
    "A8": (MEASUREMENT, [P_VALUE, P_UNIT]),
    "A9": (MEASUREMENT, [P_VALUE]),
    "A10": (MEASUREMENT, [P_UNIT]),
}


@dataclasses.dataclass
class SensorGraphSpec:
    n_observations: int = 2000
    n_sensors: int = 20
    n_timestamps: int = 50
    n_values: int = 40            # distinct measurement values
    zipf_a: float = 1.8           # value repetition skew (Fig. 8 shape)
    seed: int = 0
    include_result_links: bool = True
    # ssn:Sensor metadata stars (model/location over a few shared
    # tuples): gives cross-star BGPs a second *factorizable* class on
    # the far side of ``procedure``, so Observation-Sensor joins are
    # molecule-to-molecule (AMI x AMI).  Off by default -- the
    # single-star BENCH/test numbers predate it.
    include_sensor_metadata: bool = False


def generate(spec: SensorGraphSpec) -> TripleStore:
    rng = np.random.default_rng(spec.seed)
    n = spec.n_observations
    phen = rng.integers(0, len(PHENOMENA), n)
    sensor = rng.integers(0, spec.n_sensors, n)
    tstamp = rng.integers(0, spec.n_timestamps, n)
    # Zipf-distributed value ids, clipped to the distinct-value budget
    vals = np.minimum(rng.zipf(spec.zipf_a, n) - 1, spec.n_values - 1)

    triples: list[tuple[str, str, str]] = []
    for i in range(n):
        obs = f"obs/{i}"
        meas = f"meas/{i}"
        sens = f"sensor/{sensor[i]}"
        triples.append((obs, "rdf:type", OBSERVATION))
        triples.append((obs, P_PROPERTY, f"phenom/{PHENOMENA[phen[i]]}"))
        triples.append((obs, P_PROCEDURE, sens))
        triples.append((obs, P_GENERATED_BY, sens))
        triples.append((obs, P_TIME, f"time/{tstamp[i]}"))
        if spec.include_result_links:
            triples.append((obs, P_RESULT, meas))
        triples.append((meas, "rdf:type", MEASUREMENT))
        triples.append((meas, P_VALUE, f"val/{vals[i]}"))
        triples.append((meas, P_UNIT, f"unit/{PHENOMENA[phen[i]]}"))
    if spec.include_sensor_metadata:
        # few distinct (model, location) tuples over many sensors ->
        # high-multiplicity Sensor molecules
        for s in range(spec.n_sensors):
            sens = f"sensor/{s}"
            triples.append((sens, "rdf:type", SENSOR))
            triples.append((sens, P_MODEL, f"model/{s % 3}"))
            triples.append((sens, P_LOCATION, f"site/{s % 4}"))
    return TripleStore.from_triples(triples)


# ---------------------------------------------------------------------------
# scenario-diverse workload generators (ROADMAP item 3(b))
# ---------------------------------------------------------------------------
#
# ``generate()`` above builds one shape (SSN sensor stars) with a python
# loop -- fine at paper scale, minutes at 1M triples.  The workload
# family below targets the (scale x shape) bench grid: every shape is
# generated *vectorized* (term vocabularies are minted once as
# contiguous id blocks via ``TermDict.ids``; triple rows are assembled
# from integer arrays), so a 1M-triple graph builds in seconds.  Shapes
# stress different parts of the pipeline:
#
#   sensor      -- the paper's SSN schema (high-multiplicity stars;
#                  everything factorizes)
#   skewed      -- Zipf class sizes, per-class multiplicity spread over
#                  two orders of magnitude: the bucket ladder sees one
#                  dominant class + a long tail
#   hierarchy   -- deep linked levels, one predicate family per level:
#                  many small CSR partitions, cross-class chains
#   reified     -- RDF-star-style statement metadata (Abuoda et al.):
#                  per-statement subject/object arms block the full
#                  star, the (predicate, source, confidence) core
#                  survives -- partial-payoff factorization
#   adversarial -- multiplicity-1 molecules everywhere (Fig. 7b at
#                  scale): nothing pays off, the planner must skip
#                  every class and compression is the only win

WORKLOAD_SHAPES = ("sensor", "skewed", "hierarchy", "reified", "adversarial")


@dataclasses.dataclass
class WorkloadSpec:
    """One cell of the (scale x shape) grid: ``n_triples`` is a target
    the generators hit within a few percent (exact counts depend on
    dedup of coincident rows)."""

    shape: str = "sensor"
    n_triples: int = 10_000
    seed: int = 0
    n_classes: int = 12        # skewed: class count (Zipf sizes)
    zipf_a: float = 1.3        # skewed: class-size skew exponent
    depth: int = 6             # hierarchy: number of linked levels
    reify_fraction: float = 0.6  # reified: fraction of statements reified


def _vocab(d, prefix: str, n: int) -> np.ndarray:
    """Mint ``n`` terms ``{prefix}{i}`` as one contiguous id block."""
    return d.ids([f"{prefix}{i}" for i in range(n)])


def generate_workload(spec: WorkloadSpec) -> TripleStore:
    if spec.shape not in WORKLOAD_SHAPES:
        raise ValueError(f"unknown workload shape {spec.shape!r}; "
                         f"choose from {WORKLOAD_SHAPES}")
    rng = np.random.default_rng(spec.seed)
    store = TripleStore()
    rows = _SHAPE_BUILDERS[spec.shape](store, spec, rng)
    store.spo = np.concatenate(rows, axis=0)
    return store


def _stack(s: np.ndarray, p: int | np.ndarray, o: np.ndarray) -> np.ndarray:
    out = np.empty((len(s), 3), np.int32)
    out[:, 0] = s
    out[:, 1] = p
    out[:, 2] = o
    return out


def _sensor_rows(store, spec, rng):
    """Vectorized SSN sensor shape: 9 triples per observation, vocab
    scaled with n so the dictionary grows with the graph."""
    d = store.dict
    n = max(spec.n_triples // 9, 1)
    n_sensors = max(20, n // 200)
    n_times = max(50, n // 100)
    n_vals = max(40, n // 250)
    obs = _vocab(d, "obs/", n)
    meas = _vocab(d, "meas/", n)
    sens = _vocab(d, "sensor/", n_sensors)
    times = _vocab(d, "time/", n_times)
    vals = _vocab(d, "val/", n_vals)
    phen = d.ids([f"phenom/{p}" for p in PHENOMENA])
    units = d.ids([f"unit/{p}" for p in PHENOMENA])
    cls_o, cls_m = d.id(OBSERVATION), d.id(MEASUREMENT)
    pi = rng.integers(0, len(PHENOMENA), n)
    si = sens[rng.integers(0, n_sensors, n)]
    vi = vals[np.minimum(rng.zipf(1.8, n) - 1, n_vals - 1)]
    return [
        _stack(obs, store.TYPE, np.full(n, cls_o, np.int32)),
        _stack(obs, d.id(P_PROPERTY), phen[pi]),
        _stack(obs, d.id(P_PROCEDURE), si),
        _stack(obs, d.id(P_GENERATED_BY), si),
        _stack(obs, d.id(P_TIME), times[rng.integers(0, n_times, n)]),
        _stack(obs, d.id(P_RESULT), meas),
        _stack(meas, store.TYPE, np.full(n, cls_m, np.int32)),
        _stack(meas, d.id(P_VALUE), vi),
        _stack(meas, d.id(P_UNIT), units[pi]),
    ]


def _skewed_rows(store, spec, rng):
    """Zipf class sizes x spread multiplicities: class c gets
    ``~ n / (c+1)^a`` entities, k_c in [3, 8] properties, and its
    molecules repeat over ``2^u`` distinct star tuples."""
    d = store.dict
    weights = 1.0 / np.arange(1, spec.n_classes + 1) ** spec.zipf_a
    weights /= weights.sum()
    rows = []
    for c, w in enumerate(weights):
        k = int(rng.integers(3, 9))
        n_ents = max(int(spec.n_triples * w / (k + 1)), 2)
        ents = _vocab(d, f"c{c}/e", n_ents)
        cls = d.id(f"class/{c}")
        rows.append(_stack(ents, store.TYPE, np.full(n_ents, cls, np.int32)))
        # distinct star tuples: multiplicity ~ 2^u, u uniform in [0, 7]
        n_tuples = max(n_ents >> int(rng.integers(0, 8)), 1)
        tup = rng.integers(0, n_tuples, n_ents)
        for j in range(k):
            objs = _vocab(d, f"c{c}/p{j}/o", n_tuples)
            rows.append(_stack(ents, d.id(f"c{c}/p{j}"), objs[tup]))
    return rows


def _hierarchy_rows(store, spec, rng):
    """``depth`` linked levels; level L entities carry a ``next`` link
    into level L+1 plus two data arms over shared objects -- every
    level is its own class with its own predicate family."""
    d = store.dict
    per_level = max(spec.n_triples // (spec.depth * 4), 2)
    level_ents = [_vocab(d, f"lvl{li}/e", per_level)
                  for li in range(spec.depth)]
    rows = []
    for li in range(spec.depth):
        ents = level_ents[li]
        n = len(ents)
        cls = d.id(f"level/{li}")
        rows.append(_stack(ents, store.TYPE, np.full(n, cls, np.int32)))
        # data arms: object pools shrink with depth (deeper = more shared)
        pool = max(n // (2 ** min(li + 1, 6)), 1)
        for j in range(2):
            objs = _vocab(d, f"lvl{li}/p{j}/o", pool)
            rows.append(_stack(ents, d.id(f"lvl{li}/p{j}"),
                               objs[rng.integers(0, pool, n)]))
        if li + 1 < spec.depth:
            nxt = level_ents[li + 1]
            rows.append(_stack(ents, d.id(f"lvl{li}/next"),
                               nxt[np.arange(n) % len(nxt)]))
    return rows


def _reified_rows(store, spec, rng):
    """RDF-star-style reification: base edges plus statement nodes
    whose ``rdf:subject``/``rdf:object`` arms are statement-unique
    (blocking the full star) while (predicate, source, confidence)
    repeat heavily (the factorizable core)."""
    d = store.dict
    per_stmt = 1 + spec.reify_fraction * 6
    n = max(int(spec.n_triples / per_stmt), 2)
    n_subj = max(n // 8, 1)
    n_obj = max(n // 8, 1)
    n_preds = 7
    subs = _vocab(d, "node/s", n_subj)
    objs = _vocab(d, "node/o", n_obj)
    preds = _vocab(d, "edge/p", n_preds)
    sources = _vocab(d, "source/", 5)
    confs = _vocab(d, "conf/", 10)
    si = subs[rng.integers(0, n_subj, n)]
    oi = objs[rng.integers(0, n_obj, n)]
    pi = preds[rng.integers(0, n_preds, n)]
    rows = [_stack(si, pi[0], oi)] if n_preds == 1 else \
        [np.column_stack([si, pi, oi]).astype(np.int32)]
    m = rng.random(n) < spec.reify_fraction
    nm = int(m.sum())
    if nm:
        stmts = _vocab(d, "stmt/", nm)
        cls = d.id("rdf:Statement")
        rows += [
            _stack(stmts, store.TYPE, np.full(nm, cls, np.int32)),
            _stack(stmts, d.id("rdf:subject"), si[m]),
            _stack(stmts, d.id("rdf:predicate"), pi[m]),
            _stack(stmts, d.id("rdf:object"), oi[m]),
            _stack(stmts, d.id("prov:source"),
                   sources[rng.integers(0, 5, nm)]),
            _stack(stmts, d.id("prov:confidence"),
                   confs[rng.integers(0, 10, nm)]),
        ]
    return rows


def _adversarial_rows(store, spec, rng):
    """Fig. 7b at scale: every molecule's object tuple is unique, so
    AMI == AM for every candidate and predicted Def. 4.8 savings are
    negative everywhere -- the planner must skip every class."""
    d = store.dict
    k = 4
    n = max(spec.n_triples // (k + 1), 2)
    ents = _vocab(d, "adv/e", n)
    rows = []
    for c in range(3):
        sel = ents[c::3]
        cls = d.id(f"advclass/{c}")
        rows.append(_stack(sel, store.TYPE,
                           np.full(len(sel), cls, np.int32)))
    for j in range(k):
        objs = _vocab(d, f"adv/p{j}/u", n)   # one object per entity
        rows.append(_stack(ents, d.id(f"adv/p{j}"),
                           objs[rng.permutation(n)]))
    return rows


_SHAPE_BUILDERS = {
    "sensor": _sensor_rows,
    "skewed": _skewed_rows,
    "hierarchy": _hierarchy_rows,
    "reified": _reified_rows,
    "adversarial": _adversarial_rows,
}


def property_set_ids(store: TripleStore, sid: str) -> tuple[int, list[int]]:
    """Resolve a Table-2 SID to (class_id, property_ids) in a store."""
    cname, props = PROPERTY_SETS[sid]
    cid = store.dict.lookup(cname)
    if cid is None:
        raise KeyError(f"class {cname} not in store")
    pids = []
    for p in props:
        pid = store.dict.lookup(p)
        if pid is None:
            raise KeyError(f"property {p} not in store")
        pids.append(pid)
    return cid, pids


def figure1_graph() -> TripleStore:
    """The paper's motivating example (Figure 1a), exactly.

    c1..c4 of class C share (p1 e1), (p2 e2), (p3 e3); p4 objects: c1->e4,
    c2->e4, c3->e5, c4->e6 (multiplicities 2, 1, 1 -> AMI({p4}) = 3,
    matching §4.2's walkthrough).  20 triples total (16 property edges +
    4 type edges).
    """
    t = []
    for c in ["c1", "c2", "c3", "c4"]:
        t.append((c, "rdf:type", "C"))
        t.append((c, "p1", "e1"))
        t.append((c, "p2", "e2"))
        t.append((c, "p3", "e3"))
    t.append(("c1", "p4", "e4"))
    t.append(("c2", "p4", "e4"))
    t.append(("c3", "p4", "e5"))
    t.append(("c4", "p4", "e6"))
    return TripleStore.from_triples(t)


def figure7a_graph() -> TripleStore:
    """Paper Figure 7a: factorization pays off (savings > 0).

    5 entities of C each carrying the same objects over p1, p2, p3 and a
    distinct object over p4: 20 property edges; factorizing {p1,p2,p3}
    replaces 15 edges by 4 (star) + 5 (instanceOf) = 9 -> saves 6 edges.
    """
    t = []
    for i in range(5):
        c = f"c{i}"
        t.append((c, "rdf:type", "C"))
        t.append((c, "p1", "e1"))
        t.append((c, "p2", "e2"))
        t.append((c, "p3", "e3"))
        t.append((c, "p4", f"u{i}"))
    return TripleStore.from_triples(t)


def figure7b_graph() -> TripleStore:
    """Paper Figure 7b flavor: factorization overhead (savings < 0).

    9 entities in 9 distinct (p1, p2) object pairs -- every star pattern has
    multiplicity 1, so factorization only adds surrogates/instanceOf edges.
    """
    t = []
    for i in range(9):
        c = f"c{i}"
        t.append((c, "rdf:type", "C"))
        t.append((c, "p1", f"a{i}"))
        t.append((c, "p2", f"b{i}"))
    return TripleStore.from_triples(t)
