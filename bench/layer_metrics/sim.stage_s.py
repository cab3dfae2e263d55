"""sim.stage_s: seconds of staging the DPU groups' data and
mini-batch indices on the device (the program's ``executor.stage``
spans), summed over the traced window."""
from bench.program_spans import seconds


def read(data):
    return seconds(data, "executor.stage")
