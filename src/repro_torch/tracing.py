"""Spans and counters of the program's own work, on the host clock.

The one span recorder of the package.  A span is a named interval of host
time (``time.perf_counter``, the clock a device trace can be aligned to);
spans nest, and a count adds a host number to the innermost open span.

    with tracing.span("sca.solve"):
        ...
        tracing.count("pd_live", n)

    token = tracing.begin("engine.round", round=t)   # spans two calls
    ...
    tracing.end(token)

Recording is on while :func:`enable` is in force or while a
``torch.profiler`` session is live, so a profiled run records the
program's spans with no further switch.  Off, a span costs two flag tests
and returns a shared no-op context.  In either state nothing here touches
a tensor or synchronizes a device: every count is a number the caller
already holds on the host.

Records stay in memory, in a store of :data:`CAPACITY` records that drops
its oldest record when full (:func:`dropped` counts them).  Each is a
:class:`Span`: ``parent`` is the index of the enclosing span in
:func:`spans` (-1 for none, or for a parent already dropped) and ``round``
is the id the round's outermost span was opened with, shared by every
span inside it.  The engine loop is single-threaded, and so is the store.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import List, NamedTuple, Optional

import torch.autograd.profiler as _prof

CAPACITY = 1 << 20

# a record under construction: [name, t0, t1, parent id, round, attrs, id]
_NAME, _T0, _T1, _PARENT, _ROUND, _ATTRS, _ID = range(7)


class Span(NamedTuple):
    name: str
    t0: float
    t1: Optional[float]      # None while the span is open
    parent: int
    round: int
    attrs: dict


_enabled = False
_store: collections.deque = collections.deque(maxlen=CAPACITY)
_stack: list = []
_next_id = 0
_dropped = 0
_round = -1
_NOOP = contextlib.nullcontext()


def enable() -> None:
    """Record spans until :func:`disable`."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording by hand (a live profiler session still records)."""
    global _enabled
    _enabled = False


def recording() -> bool:
    """True while spans are recorded.  Torch's flag is read through the
    module each time: it changes when a profiler session starts."""
    return _enabled or _prof._is_profiler_enabled


def _open(name: str, round: Optional[int]) -> list:
    global _next_id, _dropped, _round
    if round is not None and not _stack:
        _round = round
    rec = [name, 0.0, None, _stack[-1][_ID] if _stack else -1, _round, {},
           _next_id]
    _next_id += 1
    if len(_store) == _store.maxlen:
        _dropped += 1
    _store.append(rec)
    _stack.append(rec)
    rec[_T0] = time.perf_counter()
    return rec


def begin(name: str, round: Optional[int] = None):
    """Open span ``name``; returns the token :func:`end` closes (None
    when not recording).  ``round``: the round id, taken when the span is
    the outermost one open."""
    if not (_enabled or _prof._is_profiler_enabled):
        return None
    return _open(name, round)


def end(token) -> None:
    """Close the span :func:`begin` returned ``token`` for."""
    if token is None:
        return
    token[_T1] = time.perf_counter()
    for i in range(len(_stack) - 1, -1, -1):
        if _stack[i] is token:
            del _stack[i]
            break


class _Scope:
    __slots__ = ("name", "round", "token")

    def __init__(self, name: str, round: Optional[int]):
        self.name, self.round = name, round

    def __enter__(self):
        self.token = _open(self.name, self.round)
        return self

    def __exit__(self, *exc):
        end(self.token)
        return False


def span(name: str, round: Optional[int] = None):
    """A context manager that records span ``name`` (a shared no-op when
    not recording).  ``round`` as :func:`begin`."""
    if not (_enabled or _prof._is_profiler_enabled):
        return _NOOP
    return _Scope(name, round)


def count(key: str, n) -> None:
    """Add ``n`` to attribute ``key`` of the innermost open span."""
    if _stack:
        attrs = _stack[-1][_ATTRS]
        attrs[key] = attrs.get(key, 0) + n


def spans() -> List[Span]:
    """The stored records, oldest first; open spans have ``t1`` None."""
    base = _next_id - len(_store)
    return [Span(r[_NAME], r[_T0], r[_T1],
                 r[_PARENT] - base if r[_PARENT] >= base else -1,
                 r[_ROUND], dict(r[_ATTRS])) for r in _store]


def dropped() -> int:
    """Records dropped from the full store since the last :func:`clear`."""
    return _dropped


def clear() -> None:
    """Empty the store and forget the open spans."""
    global _next_id, _dropped, _round
    _store.clear()
    _stack.clear()
    _next_id = _dropped = 0
    _round = -1
