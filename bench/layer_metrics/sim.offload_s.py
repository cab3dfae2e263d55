"""sim.offload_s: seconds of Engine.begin_round other than deciding (the
scenario tick, the offloading split in numpy), summed over the traced
window's rounds."""


def read(data):
    if not any(s.name == "offload" for s in data.spans):
        return None
    return data.span_sum("offload") - data.span_sum("decide")
