"""sim.account_s: seconds of Engine.finish_round (delay and energy by the
cost model, the eval pass where the round did not fuse it), summed over
the traced window's rounds."""


def read(data):
    if not any(s.name == "account" for s in data.spans):
        return None
    return data.span_sum("account")
