"""moon.moe_grouped_roofline: the Moonlight cell's grouped expert products
(the gate-up product of width 2 x 1,408, the down product, their input
gradients and the weight gradients) against their FMA / byte bound from
each launch's ``moe.grouped`` shape, over the CUDA kernels' device time,
in % (``moonlight_flops.grouped_roofline``)."""
from bench.moonlight_flops import grouped_roofline


def read(data):
    return grouped_roofline(data)
