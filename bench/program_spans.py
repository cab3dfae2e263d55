"""The program's own spans in a traced window, for the per-layer readers
that read them.

The program records its spans (``repro_torch.tracing``) while a
``torch.profiler`` session is live, on the host clock the device records
are aligned to, so the traced window's spans are those that start inside
``data.window``.  A program without the recorder has none, and every
reader then returns None.
"""
from __future__ import annotations


def window_spans(data, name: str) -> list:
    """The program's closed spans called ``name`` that start inside the
    traced window."""
    try:
        from repro_torch import tracing
    except ImportError:
        return []
    lo, hi = data.window
    return [s for s in tracing.spans()
            if s.name == name and s.t1 is not None and lo <= s.t0 < hi]


def seconds(data, name: str, per_round: bool = False):
    """Seconds in spans ``name`` over the window (a round's mean with
    ``per_round``), or None where there are none."""
    spans = window_spans(data, name)
    if not spans:
        return None
    total = sum(s.t1 - s.t0 for s in spans)
    return total / len(data.rounds) if per_round else total


def attr_sum(spans, key: str) -> float:
    return sum(s.attrs.get(key, 0) for s in spans)
