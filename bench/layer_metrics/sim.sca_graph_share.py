"""sim.sca_graph_share: the share of the SCA outer steps run by replaying
a captured CUDA graph (``graph_replays`` over ``graph_replays`` plus
``eager_outer`` of the program's ``sca.solve`` spans), over the traced
window, in %; None where no solve counts its outer steps."""
from bench.program_spans import attr_sum, window_spans


def read(data):
    spans = window_spans(data, "sca.solve")
    replays = attr_sum(spans, "graph_replays")
    steps = replays + attr_sum(spans, "eager_outer")
    if not steps:
        return None
    return 100.0 * replays / steps
