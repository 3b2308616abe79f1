"""LinkedSensorData graphs as id rows plus a term list, made from a seed.

A vectorized numpy copy of ``src/repro_torch/data/synthetic.py``
``generate(SensorGraphSpec)`` (itself the port of
``src/repro/data/synthetic.py``): the same SSN schema (Observation with
``observedProperty / procedure / generatedBy / samplingTime /
observationResult``, Measurement with ``value / unit``, and optionally
the station descriptions, ``ssn:Sensor`` with ``model / location``),
the same distributions drawn in the same order from the generator, so
a graph made here holds the same term triples as ``generate`` made
with the same seed.  It builds the id rows directly instead of looping
over Python tuples, so 1.8M triples take about a second.

Ids are positions in the term list: ``rdf:type`` and
``repro:instanceOf`` first (the two ids every store reserves), then the
classes, the predicates and the object vocabularies, each a contiguous
block, so ``val/k`` ids ascend with ``k``.  Both the program and the
plain reference receive exactly ``(terms, spo)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PHENOMENA = ("Temperature", "WindSpeed", "WindDirection", "RelativeHumidity",
             "Visibility", "Precipitation", "Pressure", "Rainfall",
             "Snowfall")
RDF_TYPE = "rdf:type"
INSTANCE_OF = "repro:instanceOf"
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
PREDICATES = (P_PROPERTY, P_PROCEDURE, P_GENERATED_BY, P_TIME, P_RESULT,
              P_VALUE, P_UNIT, P_MODEL, P_LOCATION)
N_MODELS = 3          # synthetic.generate: model/{s % 3}, site/{s % 4}
N_SITES = 4


@dataclasses.dataclass(frozen=True)
class SensorSpec:
    """The scale and shape of one graph."""

    n_observations: int
    n_sensors: int
    n_timestamps: int
    n_values: int
    zipf_a: float = 1.8
    include_sensor_metadata: bool = False

    @classmethod
    def from_config(cls, cfg: dict) -> "SensorSpec":
        """The spec of a configuration file: its scale at the top level,
        the generator's fitted numbers under ``assumed``, and as many
        sampling instants as ``timestamps_per_observation`` times the
        observations."""
        n = int(cfg["n_observations"])
        a = cfg["assumed"]
        return cls(n_observations=n, n_sensors=int(a["n_sensors"]),
                   n_timestamps=max(1, round(
                       n * float(cfg["timestamps_per_observation"]))),
                   n_values=int(a["n_values"]), zipf_a=float(a["zipf_a"]),
                   include_sensor_metadata=bool(
                       cfg["include_sensor_metadata"]))


spec_from_config = SensorSpec.from_config


class Vocabulary:
    """The term list of every graph of one spec, and the id blocks in it.

    Every graph of a spec shares this list: only the rows differ from
    seed to seed, so a pool of graphs holds one list."""

    def __init__(self, spec: SensorSpec) -> None:
        n = spec.n_observations
        terms = [RDF_TYPE, INSTANCE_OF, OBSERVATION, MEASUREMENT]
        if spec.include_sensor_metadata:
            terms.append(SENSOR)
        terms.extend(PREDICATES)
        self.base = {t: i for i, t in enumerate(terms)}
        blocks = (("phenom", [f"phenom/{p}" for p in PHENOMENA]),
                  ("unit", [f"unit/{p}" for p in PHENOMENA]),
                  ("sensor", [f"sensor/{i}" for i in range(spec.n_sensors)]),
                  ("time", [f"time/{i}" for i in range(spec.n_timestamps)]),
                  ("val", [f"val/{i}" for i in range(spec.n_values)]),
                  ("model", [f"model/{i}" for i in range(N_MODELS)]),
                  ("site", [f"site/{i}" for i in range(N_SITES)]),
                  ("obs", [f"obs/{i}" for i in range(n)]),
                  ("meas", [f"meas/{i}" for i in range(n)]))
        self.start: dict[str, int] = {}
        for name, block in blocks:
            self.start[name] = len(terms)
            terms.extend(block)
        self.terms = terms

    def id(self, term: str) -> int:
        """The id of a schema term (class or predicate)."""
        return self.base[term]


def observation_draws(rng: np.random.Generator, n: int, spec: SensorSpec):
    """``n`` observations' (phenomenon, sensor, timestamp, value) indices,
    drawn in ``generate``'s order."""
    phen = rng.integers(0, len(PHENOMENA), n)
    sensor = rng.integers(0, spec.n_sensors, n)
    tstamp = rng.integers(0, spec.n_timestamps, n)
    vals = np.minimum(rng.zipf(spec.zipf_a, n) - 1, spec.n_values - 1)
    return phen, sensor, tstamp, vals


def _rows(s, p, o) -> np.ndarray:
    out = np.empty((len(s), 3), np.int32)
    out[:, 0] = s
    out[:, 1] = p
    out[:, 2] = o
    return out


def graph_rows(vocab: Vocabulary, spec: SensorSpec,
               rng: np.random.Generator) -> np.ndarray:
    """The (n, 3) int32 id rows of one graph drawn from ``rng``."""
    n = spec.n_observations
    phen, sensor, tstamp, vals = observation_draws(rng, n, spec)
    st, v = vocab.start, vocab.id
    obs = st["obs"] + np.arange(n)
    meas = st["meas"] + np.arange(n)
    sens = st["sensor"] + sensor
    parts = [
        _rows(obs, v(RDF_TYPE), np.full(n, v(OBSERVATION))),
        _rows(obs, v(P_PROPERTY), st["phenom"] + phen),
        _rows(obs, v(P_PROCEDURE), sens),
        _rows(obs, v(P_GENERATED_BY), sens),
        _rows(obs, v(P_TIME), st["time"] + tstamp),
        _rows(obs, v(P_RESULT), meas),
        _rows(meas, v(RDF_TYPE), np.full(n, v(MEASUREMENT))),
        _rows(meas, v(P_VALUE), st["val"] + vals),
        _rows(meas, v(P_UNIT), st["unit"] + phen),
    ]
    if spec.include_sensor_metadata:
        s = np.arange(spec.n_sensors)
        ids = st["sensor"] + s
        parts += [
            _rows(ids, v(RDF_TYPE), np.full(len(s), v(SENSOR))),
            _rows(ids, v(P_MODEL), st["model"] + s % N_MODELS),
            _rows(ids, v(P_LOCATION), st["site"] + s % N_SITES),
        ]
    return np.concatenate(parts)


def seeded_rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of ``seed`` (any whole number, negative or above 64
    bits folded in), optionally split into numbered streams."""
    root = int(seed) % (1 << 64)
    return np.random.default_rng([root, *stream] if stream else root)
