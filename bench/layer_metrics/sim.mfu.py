"""sim.mfu: the classifier's forward and backward operations for the
examples the rounds' plans trained (gamma_i mini-batches of each live
DPU), over the traced window, over the float32 peak, in %."""
import numpy as np

from bench.roofline import PEAK_F32_FLOPS, mlp_train_flops


def read(data):
    examples = data.counter_sum("train_examples")
    if not examples or data.window_s <= 0:
        return None
    m = data.config["model"]
    dims = [int(np.prod(m["input_shape"]))] + list(m["hidden"]) \
        + [m["num_classes"]]
    return 100.0 * mlp_train_flops(dims, examples) / data.window_s \
        / PEAK_F32_FLOPS
