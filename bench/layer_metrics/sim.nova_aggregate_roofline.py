"""sim.nova_aggregate_roofline: the one-plane eq.-11 kernel's share of its
roofline, in %."""
from bench.roofline import kernel_share


def read(data):
    return kernel_share(data, "nova_aggregate", "nova_aggregate_kernel")
