"""nano.mfu: the Nemotron-H period's training operations (three times the
forward's matmuls: the layers every token takes and the lm_head per
token, the routed experts per held pair as the program counted them in
its ``moe.counts`` spans; no recompute) in the traced window, over the
window, over the float32 peak (TF32 off), in %."""
from bench.nemotron_flops import train_flops
from bench.program_spans import attr_sum, window_spans
from bench.roofline import PEAK_F32_FLOPS


def read(data):
    tokens = data.counter_sum("tokens")
    counts = window_spans(data, "moe.counts")
    if not tokens or not counts or data.window_s <= 0:
        return None
    flops = train_flops(data.config, data.workload["seq"], tokens,
                        attr_sum(counts, "moe_pairs_held"))
    return 100.0 * flops / data.window_s / PEAK_F32_FLOPS
