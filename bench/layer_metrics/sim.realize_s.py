"""sim.realize_s: seconds of the offloading split (the program's
``engine.offload`` span around ``realize_offloading``, numpy), summed over
the traced window."""
from bench.program_spans import seconds


def read(data):
    return seconds(data, "engine.offload")
