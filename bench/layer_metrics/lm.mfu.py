"""lm.mfu: the model's training operations (three times the forward's
matmuls, no recompute) for the tokens trained in the traced window, over
the window, over the float32 peak (TF32 off), in %."""
from bench.roofline import PEAK_F32_FLOPS, mamba2_train_flops


def read(data):
    tokens = data.counter_sum("tokens")
    if not tokens or data.window_s <= 0:
        return None
    flops = mamba2_train_flops(data.config, data.workload["seq"], tokens)
    return 100.0 * flops / data.window_s / PEAK_F32_FLOPS
