"""sim.sca_launches: device records (kernels and copies) that start
inside the program's ``sca.solve`` spans, per solve of the traced window."""
from bench.program_spans import window_spans


def read(data):
    solves = window_spans(data, "sca.solve")
    if not solves:
        return None
    n = sum(1 for s in solves for _, start, _ in data.records
            if s.t0 <= start < s.t1)
    return n / len(solves)
