"""sim.scenario_s: seconds of the scenario tick (the program's
``scenario.step`` span: the feed's arrivals and the rate jitter), summed
over the traced window."""
from bench.program_spans import seconds


def read(data):
    return seconds(data, "scenario.step")
