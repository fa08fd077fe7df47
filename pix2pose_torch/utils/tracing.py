"""In-process recorder of host spans, cross-thread waits and counters.

Off by default. A caller that wants a trace (a benchmark, a profiling
session) calls :func:`enable`, runs the work and collects the records
with :func:`take`; nothing is written anywhere.

- :func:`span` ``(name, items)`` times a block on the calling thread:
  ``(name, start_ns, end_ns, items, span_id, parent_id, thread_id)``,
  ``parent_id`` the innermost span open on the same thread (0 for none).
- :func:`wait` records an interval that one thread opened and another
  closed, such as a request's time in a queue:
  ``(name, start_ns, end_ns, id, parent_id)``, kept apart from spans.
- :func:`count` adds to a named integer counter.

Both ends of a span read ``time.time_ns()``, the clock that torch.profiler
stamps its device events on, so spans line up with a device trace. A span
measures host time only: it never synchronizes the device and emits no
profiler annotation (a ``record_function`` range would appear among the
device's events). When the recorder is off, :func:`span` returns one
shared no-op object after a single boolean check, and :func:`wait` and
:func:`count` return at once.
"""

from __future__ import annotations

import itertools
import threading
import time

_on = False
_spans: list = []
_waits: list = []
_counts: dict = {}
_ids = itertools.count(1)
_lock = threading.Lock()
_open = threading.local()   # per thread: the ids of the open spans


class _Off:
    """The span :func:`span` returns when the recorder is off."""

    __slots__ = ()
    id = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "items", "id", "parent", "start")

    def __init__(self, name: str, items: int):
        self.name = name
        self.items = items

    def __enter__(self):
        stack = getattr(_open, "ids", None)
        if stack is None:
            stack = _open.ids = []
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.ids.pop()
        _spans.append((self.name, self.start, end, self.items, self.id,
                       self.parent, threading.get_ident()))
        return False


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, items: int = 1):
    """A context manager timing its block (see the module's docstring)."""
    if not _on:
        return OFF
    return _Span(name, items)


def wait(name: str, start_ns: int, end_ns: int, ident: int,
         parent_id: int):
    if _on:
        _waits.append((name, start_ns, end_ns, ident, parent_id))


def count(name: str, n: int):
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def take() -> dict:
    """``{"spans": [...], "waits": [...], "counts": {...}}`` recorded so
    far, in the order they closed; the recorder starts empty again."""
    global _spans, _waits, _counts
    with _lock:
        out = {"spans": _spans, "waits": _waits, "counts": _counts}
        _spans, _waits, _counts = [], [], {}
    return out
