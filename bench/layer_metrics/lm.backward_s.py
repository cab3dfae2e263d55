"""lm.backward_s: host seconds of the round step's backward passes
(the program's ``round_step.backward`` spans: ``torch.autograd.grad``, the
remat recompute inside it), per round of the traced window."""
from bench.program_spans import seconds


def read(data):
    return seconds(data, "round_step.backward", per_round=True)
