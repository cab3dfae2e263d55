"""moon.moe_load_max: the most-loaded held expert's pairs over the held
experts' mean, the largest over a round's forward calls (the program's
``moe.counts`` spans), averaged over the traced window's rounds."""
from bench.program_spans import window_spans


def read(data):
    counts = window_spans(data, "moe.counts")
    if not counts:
        return None
    return sum(s.attrs.get("moe_load_max", 0.0) for s in counts) \
        / len(counts)
