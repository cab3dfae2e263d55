"""moon.mla_s: host seconds in the program's ``attn.mla`` spans (each
latent-attention layer's forward, remat recomputes included), per round
of the traced window."""
from bench.program_spans import seconds


def read(data):
    return seconds(data, "attn.mla", per_round=True)
