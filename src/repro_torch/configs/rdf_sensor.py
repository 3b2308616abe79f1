"""The paper's own workload, plain data: LinkedSensorData-scale FSP
detection + factorization (not an LM arch).  D1/D1D2/D1D2D3 mirror the
paper's gradual-merge evaluation.  The port's copy of
``repro/configs/rdf_sensor.py``."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class RDFWorkloadConfig:
    name: str
    n_observations: int
    n_sensors: int
    n_timestamps: int
    n_values: int
    zipf_a: float = 1.8
    seed: int = 0


D1 = RDFWorkloadConfig("rdf-d1", 40_000, 200, 500, 400, seed=1)
D1D2 = RDFWorkloadConfig("rdf-d1d2", 120_000, 200, 1200, 400, seed=2)
D1D2D3 = RDFWorkloadConfig("rdf-d1d2d3", 200_000, 200, 2000, 400, seed=3)
SMALL = RDFWorkloadConfig("rdf-small", 2_000, 20, 50, 40, seed=0)
