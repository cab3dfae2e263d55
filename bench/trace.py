"""The traced run's instruments: host spans and counters taken around the
benchmark's calls into the program, the launch shapes of the program's
hand-written kernels, and the device's kernel records from
``torch.profiler`` (CUDA activity only), aligned to the host clock.

The profiler is known to drop records on this card, so the records of
the hand-written kernels are counted against the program's own launch
counters (``repro_torch.kernels.cuda.LAUNCHES``) round by round, and the
traced window keeps the longest run of leading rounds on which the two
agree.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List

import torch

# device kernel name -> the program's launch counter(s) it serves
KERNEL_SYMBOLS = {"fedprox_accum_kernel": ("fedprox_accum",),
                  "nova_aggregate_kernel": ("nova_aggregate",
                                            "nova_aggregate_stacked")}


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    round: int


class Tracer:
    """Spans, counters and kernel launches of one run.  With
    ``enabled=False`` every method is a cheap no-op, so the drivers call
    them unconditionally."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.round = -1
        self.spans: List[Span] = []
        self.counters: Dict[int, dict] = {}
        self.launches: List[dict] = []
        self.round_launches: Dict[int, dict] = {}
        self._prof = None
        self._marker_host = None
        self._patched = []

    # --- host side ---------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                torch.cuda.synchronize()
            self.spans.append(Span(name, t0, time.perf_counter(), self.round))

    def add_span(self, name: str, t0: float, t1: float) -> None:
        if self.enabled:
            self.spans.append(Span(name, t0, t1, self.round))

    def count(self, name: str, value) -> None:
        if self.enabled:
            c = self.counters.setdefault(self.round, {})
            c[name] = c.get(name, 0) + value

    def begin_round(self, t: int) -> None:
        self.round = t
        if self.enabled:
            self._launch_mark = dict(self._counter())

    def end_round(self) -> None:
        if self.enabled:
            now = self._counter()
            self.round_launches[self.round] = {
                k: now[k] - self._launch_mark.get(k, 0) for k in now}

    @staticmethod
    def _counter() -> dict:
        from repro_torch.kernels import cuda
        return dict(cuda.LAUNCHES)

    # --- kernel launch shapes ------------------------------------------
    def patch_kernels(self) -> None:
        """Record each launch's shapes by wrapping the program's kernel
        wrappers (the dispatch layer looks them up at call time)."""
        if not self.enabled:
            return
        from repro_torch.kernels import fedprox_update, nova_aggregate

        def wrap(mod, attr, describe):
            orig = getattr(mod, attr)

            def recorded(*args, **kw):
                rec = describe(*args)
                rec.update(kernel=attr, round=self.round,
                           elem_bytes=args[0].element_size())
                self.launches.append(rec)
                return orig(*args, **kw)
            setattr(mod, attr, recorded)
            self._patched.append((mod, attr, orig))

        wrap(fedprox_update, "fedprox_accum",
             lambda x, g, anchor, *a: {"G": x.shape[0], "R": x.shape[1],
                                       "anchor_stacked": anchor.dim() == 3})
        wrap(nova_aggregate, "nova_aggregate",
             lambda x, d, *a: {"n": d.shape[0], "R": x.shape[0],
                               "replicas": 1})
        wrap(nova_aggregate, "nova_aggregate_stacked",
             lambda x, d, *a: {"n": d.shape[0], "R": x.shape[1],
                               "replicas": x.shape[0]})

    def unpatch(self) -> None:
        for mod, attr, orig in self._patched:
            setattr(mod, attr, orig)
        self._patched = []

    # --- device side ---------------------------------------------------
    def start_profiler(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        # a marker kernel launched right after a synchronize ties the
        # device clock of the records to the host clock
        torch.cuda.synchronize()
        self._marker_host = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop_profiler(self) -> List[tuple]:
        """Stop the profiler; returns the device records as (name, start,
        end) in host seconds, sorted by start."""
        if self._prof is None:
            return []
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        raw = _device_events(self._prof)
        self._prof = None
        marker = [e for e in raw if "spin" in e[0]]
        if not marker:
            raise RuntimeError("the profiler returned no marker kernel: no "
                               "device records to align")
        off = self._marker_host - marker[0][1]
        return sorted(((n, s + off, e + off) for n, s, e in raw
                       if "spin" not in n), key=lambda r: r[1])


def _device_events(prof) -> List[tuple]:
    """(name, start_s, end_s) of every device activity record, in the
    profiler's clock."""
    out = []
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None and hasattr(res, "events"):
        for e in res.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = e.start_ns() * 1e-9
            out.append((e.name(), s, s + e.duration_ns() * 1e-9))
        return out
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start * 1e-6,
                        e.time_range.end * 1e-6))
    return out


@dataclasses.dataclass
class TraceData:
    """What the per-layer readers read: the kept rounds' spans, counters,
    kernel launches and device records, and the traced window."""
    spans: List[Span]
    counters: Dict[int, dict]
    launches: List[dict]
    records: List[tuple]
    rounds: List[int]
    window: tuple
    config: dict
    workload: dict
    completeness: dict

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds in which the device ran anything, intervals merged."""
        busy, end = 0.0, float("-inf")
        for _, s, e in self.records:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def kernel_records(self, symbol: str) -> List[tuple]:
        return [r for r in self.records if symbol in r[0]]

    def span_sum(self, name: str) -> float:
        return sum(s.t1 - s.t0 for s in self.spans if s.name == name)

    def counter_sum(self, name: str) -> float:
        return sum(c.get(name, 0) for c in self.counters.values())


def assemble(tracer: Tracer, records: List[tuple], round_spans: List[Span],
             config: dict, workload: dict) -> TraceData:
    """Cut the trace to the leading rounds whose device records of the
    hand-written kernels match the launch counters, round by round."""
    kept, checked = [], []
    for sp in round_spans:
        inside = [r for r in records if sp.t0 <= r[1] < sp.t1]
        ok = True
        for symbol, counters in KERNEL_SYMBOLS.items():
            want = sum(tracer.round_launches.get(sp.round, {}).get(c, 0)
                       for c in counters)
            got = sum(symbol in r[0] for r in inside)
            ok &= want == got
        checked.append(ok)
        if not ok:
            break
        kept.append(sp)
    completeness = {"rounds_traced": len(round_spans),
                    "rounds_kept": len(kept),
                    "all_agree": all(checked) and len(kept) == len(round_spans)}
    if not kept:
        return TraceData([], {}, [], [], [], (0.0, 0.0), config, workload,
                         completeness)
    lo, hi = kept[0].t0, kept[-1].t1
    rounds = [sp.round for sp in kept]
    keep = set(rounds)
    return TraceData(
        spans=[s for s in tracer.spans if s.round in keep],
        counters={r: c for r, c in tracer.counters.items() if r in keep},
        launches=[x for x in tracer.launches if x["round"] in keep],
        records=[r for r in records if lo <= r[1] < hi],
        rounds=rounds, window=(lo, hi), config=config, workload=workload,
        completeness=completeness)


def breakdown(data: TraceData, host_spans=()) -> dict:
    """The ten device operations that took most time, and the ten largest
    sums of idle gaps by the host span that covers each gap."""
    by_op: Dict[str, float] = {}
    for n, s, e in data.records:
        by_op[n] = by_op.get(n, 0.0) + (e - s)
    gaps: Dict[str, float] = {}
    spans = [s for s in data.spans if s.name in host_spans]
    end = data.window[0]
    for n, s, e in data.records + [("", data.window[1], data.window[1])]:
        if s > end:
            mid = 0.5 * (s + end)
            owner = [sp for sp in spans if sp.t0 <= mid < sp.t1]
            name = min(owner, key=lambda sp: sp.t1 - sp.t0).name \
                if owner else "between spans"
            gaps[name] = gaps.get(name, 0.0) + (s - end)
        end = max(end, e)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(gaps)}
