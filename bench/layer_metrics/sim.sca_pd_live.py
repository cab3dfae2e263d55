"""sim.sca_pd_live: the share of the primal-dual iterations run that
moved the duals (``pd_live`` over ``pd_run`` of the program's ``sca.solve``
spans; the rest are frozen work), over the traced window, in %."""
from bench.program_spans import attr_sum, window_spans


def read(data):
    spans = window_spans(data, "sca.solve")
    run = attr_sum(spans, "pd_run")
    if not run:
        return None
    return 100.0 * attr_sum(spans, "pd_live") / run
