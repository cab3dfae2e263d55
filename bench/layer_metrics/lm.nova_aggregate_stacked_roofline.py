"""lm.nova_aggregate_stacked_roofline: the replica-stack eq.-11 kernel's
share of its roofline, in %."""
from bench.roofline import kernel_share


def read(data):
    return kernel_share(data, "nova_aggregate_stacked",
                        "nova_aggregate_kernel")
