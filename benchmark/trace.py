"""The traced run's instruments: host spans around public calls into the
program's layers, CUDA-event timers, and a torch.profiler sub-window at
the end of the measured window, reduced to the device's busy time, its
costliest operations and its idle gaps by the host span they fell in."""

from __future__ import annotations

import time

import torch


class Spans:
    """Host spans ``(name, start_ns, end_ns, items)`` on the wall clock
    (``time.time_ns``, which the profiler's events also use) around wrapped
    calls; each ends after a ``torch.cuda.synchronize`` when ``sync``.
    ``items(args)`` counts the work of a call (frames, for instance)."""

    def __init__(self):
        self.records: list = []

    def wrap(self, obj, attr: str, name: str, sync: bool = True,
             items=lambda a: 1):
        orig = getattr(obj, attr)

        def wrapped(*a, **kw):
            t0 = time.time_ns()
            out = orig(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            self.records.append((name, t0, time.time_ns(), items(a)))
            return out

        setattr(obj, attr, wrapped)

    def add(self, name: str, t0: int, t1: int, items: int = 1):
        self.records.append((name, t0, t1, items))

    def select(self, name: str, since_ns: int = 0, until_ns=None) -> list:
        return [r for r in self.records if r[0] == name and r[1] >= since_ns
                and (until_ns is None or r[1] < until_ns)]

    def total_s(self, name: str, since_ns: int = 0, until_ns=None) -> float:
        return sum(e - s for _, s, e, _ in
                   self.select(name, since_ns, until_ns)) / 1e9

    def items(self, name: str, since_ns: int = 0, until_ns=None) -> int:
        return sum(n for *_, n in self.select(name, since_ns, until_ns))


class Profile:
    """torch.profiler over CUDA activity between :meth:`start` and
    :meth:`stop`, both called from the thread that launches the work (the
    profiler sees the kernels of the thread that started it)."""

    def __init__(self, start_ns: int = 0, stop_ns: int = 0):
        self.prof = None
        self.t0 = self.t1 = 0
        self.start_ns, self.stop_ns = start_ns, stop_ns
        self.done = False

    def around(self, fn):
        """``fn`` wrapped to start the profiler before the first call that
        begins at or after ``start_ns`` and to stop it after the first call
        that ends at or after ``stop_ns``."""

        def wrapped(*a, **kw):
            if self.prof is None and time.time_ns() >= self.start_ns:
                self.start()
            out = fn(*a, **kw)
            if self.prof is not None and not self.done \
                    and time.time_ns() >= self.stop_ns:
                self.stop()
            return out

        return wrapped

    def start(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.time_ns()

    def stop(self):
        self.done = True
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(None, None, None)

    def kernels(self) -> list:
        """[(name, start_ns, end_ns)] of the device's operations, on the
        wall clock (``time.time_ns``) as the profiler stamps them."""
        return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in self.prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA]


def reduce_profile(prof: Profile, spans: Spans, top: int = 10) -> dict:
    """Busy seconds (the union of device operations inside the profiled
    window), the window's seconds, the costliest operations by name, and
    the idle gaps summed by the innermost host span at each gap's middle
    (``idle`` outside every span)."""
    t0, t1 = prof.t0, prof.t1
    kern = prof.kernels()
    ops = sorted((max(s, t0), min(e, t1), n) for n, s, e in kern
                 if e > t0 and s < t1)
    by_name: dict = {}
    for s, e, n in ops:
        by_name[n] = by_name.get(n, 0) + (e - s)
    busy, gaps, cur = 0, [], t0
    for s, e, _ in ops:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if t1 > cur:
        gaps.append((cur, t1))
    inside = [(s, e, n) for n, s, e, _ in spans.records
              if e > t0 and s < t1]
    by_span: dict = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        cover = [(s, n) for s, e, n in inside if s <= mid < e]
        name = max(cover)[1] if cover else "idle"
        by_span[name] = by_span.get(name, 0) + (g1 - g0)
    rank = lambda d: [[k, v / 1e9] for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9,
            "n_ops": len(ops), "device_ops": rank(by_name),
            "idle_gaps": rank(by_span)}
