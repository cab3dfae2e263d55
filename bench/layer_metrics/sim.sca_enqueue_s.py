"""sim.sca_enqueue_s: host seconds of enqueuing the SCA outer steps
(the program's ``sca.outer`` spans, host reads excluded), summed over the
traced window."""
from bench.program_spans import seconds


def read(data):
    return seconds(data, "sca.outer")
