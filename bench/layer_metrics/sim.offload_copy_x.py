"""sim.offload_copy_x: bytes of rows the offloading split allocates over
the bytes of the rows it splits (the ``offload_bytes`` and
``round_bytes`` counts of the program's ``engine.offload`` spans), summed
over the traced window; 1.0 is one copy of every row."""
from bench.program_spans import attr_sum, window_spans


def read(data):
    spans = window_spans(data, "engine.offload")
    split = attr_sum(spans, "round_bytes")
    if not split:
        return None
    return attr_sum(spans, "offload_bytes") / split
