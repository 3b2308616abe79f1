"""Share of the candidate-rows the window's sweeps hashed that count
toward some AMI: 100 * sum of ``kept`` (each candidate's |E(SP)|) over
the sum of ``candidates * rows`` of every ``sweep`` span inside an op,
in %.  None where the program's sweeps record no ``kept``."""
from bench_port.program_spans import group_by_op, op_intervals, \
    program_records


def read(run):
    recs = program_records(run)
    if not recs:
        return None
    kept = hashed = 0
    for group in group_by_op(recs, op_intervals(run.trace)):
        for r in group:
            if r.name == "sweep" and "kept" in r.attrs:
                kept += r.attrs["kept"]
                hashed += r.attrs.get("candidates", 0) * r.attrs.get(
                    "rows", 0)
    return 100.0 * kept / hashed if hashed else None
