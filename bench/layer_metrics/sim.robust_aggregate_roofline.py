"""sim.robust_aggregate_roofline: the robust kernel's share of its
roofline, in %: each launch's bytes, 4·R·1024·(n+2) (the n d_i planes
and x read, x written, float32) at the n and R of its ``robust.aggregate``
program span, over HBM bandwidth, over the device time of the robust
kernels' records (the sorting network's or the radix select's).  Where
the profiler dropped records, the launches are counted by their mean
bound, once a record."""
from bench.program_spans import window_spans
from bench.roofline import bound_seconds, nova_aggregate_bytes

SYMBOLS = ("robust_aggregate_kernel", "robust_select_kernel")


def read(data):
    launches = [s.attrs for s in window_spans(data, "robust.aggregate")]
    records = [r for r in data.records if any(k in r[0] for k in SYMBOLS)]
    if not launches or not records:
        return None
    mean = sum(bound_seconds(nova_aggregate_bytes(x["n"], x["R"], 1))
               for x in launches) / len(launches)
    device = sum(e - s for _, s, e in records[:len(launches)])
    return 100.0 * mean * min(len(records), len(launches)) / device
