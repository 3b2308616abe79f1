"""Median per op of the rows of every ``extract`` span over the entities
(``am``) of every ``detect`` span: object-matrix rows pulled per entity
planned."""
from bench_port.program_spans import extract_rows_per_entity


def read(run):
    return extract_rows_per_entity(run)
