"""sim.fedprox_accum_roofline: fedprox_accum's share of its roofline
(bytes at each launch's shape over 3.35 TB/s, over the kernel's device
time), in %."""
from bench.roofline import kernel_share


def read(data):
    return kernel_share(data, "fedprox_accum", "fedprox_accum_kernel")
