"""lm.forward_s: host seconds of the round step's forward passes
(the program's ``round_step.forward`` spans), per round of the traced
window."""
from bench.program_spans import seconds


def read(data):
    return seconds(data, "round_step.forward", per_round=True)
