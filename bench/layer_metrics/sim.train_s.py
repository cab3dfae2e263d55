"""sim.train_s: host seconds of the local-step loops (the program's
``executor.train`` spans: gathers, forward, backward and the
``fedprox_accum`` launches, enqueued), summed over the traced window."""
from bench.program_spans import seconds


def read(data):
    return seconds(data, "executor.train")
