"""sim.device_idle: the share of the traced window in which the device
ran nothing, in %."""


def read(data):
    if data.window_s <= 0:
        return None
    return 100.0 * (1.0 - data.busy_s() / data.window_s)
