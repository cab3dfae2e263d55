"""sim.sca_sync_s: host seconds the SCA solve waits at its host reads
(the program's ``sca.sync`` spans: the objective, violation and
iteration count of each outer step), summed over the traced window."""
from bench.program_spans import seconds


def read(data):
    return seconds(data, "sca.sync")
