"""nano.ssd_s: host seconds in the program's ``mamba.ssd`` spans (the
chunked SSD, forward passes and remat recomputes), per round of the
traced window."""
from bench.program_spans import seconds


def read(data):
    return seconds(data, "mamba.ssd", per_round=True)
