"""nano.moe_grouped_roofline: the grouped expert products' share of their
roofline, in %: the bound of each launch (max of operations over the
float32 peak and bytes over HBM bandwidth, at the pairs, experts, K and N
its ``moe.grouped`` span recorded) over the device time of the CUDA
kernels' records (``csrc/grouped_mm.cu``).  Where the profiler dropped records, each kind's
launches are counted by their mean bound, once a record."""
from bench.nemotron_flops import grouped_bound_seconds
from bench.program_spans import window_spans

SYMBOLS = {"mm": "grouped_mm_kernel", "wgrad": "grouped_wgrad_kernel"}


def read(data):
    launches = [s.attrs for s in window_spans(data, "moe.grouped")
                if "pairs" in s.attrs]
    bound = device = 0.0
    for kind, symbol in SYMBOLS.items():
        mine = [x for x in launches if x["kind"] == kind]
        records = data.kernel_records(symbol)
        if not mine or not records:
            continue
        mean = sum(grouped_bound_seconds(x) for x in mine) / len(mine)
        bound += mean * min(len(records), len(mine))
        device += sum(e - s for _, s, e in records[:len(mine)])
    return 100.0 * bound / device if device > 0 else None
