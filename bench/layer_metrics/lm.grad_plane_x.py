"""lm.grad_plane_x: bytes the round step's backward passes wrote into
gradient planes over the bytes of the planes they returned (the
``grad_plane_bytes`` and ``plane_bytes`` counts of the program's
``round_step.backward`` spans), summed over the traced window; 1.0 is one
write of every plane."""
from bench.program_spans import attr_sum, window_spans


def read(data):
    spans = window_spans(data, "round_step.backward")
    planes = attr_sum(spans, "plane_bytes")
    if not planes:
        return None
    return attr_sum(spans, "grad_plane_bytes") / planes
