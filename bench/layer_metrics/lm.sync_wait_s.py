"""lm.sync_wait_s: seconds from the round step's return to the end of
torch.cuda.synchronize(), per round of the traced window: the device's
tail behind the host."""


def read(data):
    spans = [s for s in data.spans if s.name == "sync_wait"]
    return sum(s.t1 - s.t0 for s in spans) / len(spans) if spans else None
