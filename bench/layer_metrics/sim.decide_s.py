"""sim.decide_s: seconds the strategy took to decide plans (Engine.decide,
the cefl SCA solve or a heuristic), synchronized, summed over the traced
window's rounds."""


def read(data):
    spans = [s for s in data.spans if s.name == "decide"]
    return sum(s.t1 - s.t0 for s in spans) if spans else None
