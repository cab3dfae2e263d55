"""sim.device_round_s: seconds of Engine.execute_round (staging, FedProx
local steps, eq.-11 aggregation, a fused eval) to a synchronize, summed
over the traced window's rounds."""


def read(data):
    if not any(s.name == "device_round" for s in data.spans):
        return None
    return data.span_sum("device_round")
