"""sim.h2d_mb: megabytes of host arrays the staging copies to the
device (the ``h2d_bytes`` counts of the program's ``executor.stage``
spans), per round of the traced window."""
from bench.program_spans import attr_sum, window_spans


def read(data):
    spans = window_spans(data, "executor.stage")
    if not spans:
        return None
    return attr_sum(spans, "h2d_bytes") / 1e6 / len(data.rounds)
