"""Spans and counters of the port's host code, recorded while a torch
profiler session runs.

* ``span(name, request=None)``, a context manager or a decorator: the
  name, the thread, the parent (the innermost open span of the same
  thread), a request id (a root span's from its caller, a child's from its
  parent) and ``time.perf_counter_ns()`` at its start and end.
* ``count(name, n)`` adds ``n`` to a counter.
* ``snapshot()``: the closed spans (each with its self time: its duration
  less its children's), the counters and the totals by span name.

One switch: recording is on exactly while a profiler session runs
(``torch.autograd.profiler._is_profiler_enabled``, the process-wide flag,
which a second thread reads too), so the benchmark's traced sub-window and
``--profile_dir`` both turn it on. Off, a site reads that flag and
returns; it records nothing and never enters ``record_function``. On, a
span also enters ``torch.profiler.record_function(name)``, so a span of
the thread that runs the profiler lands in its trace, on its clock, as a
``user_annotation`` event (another thread's spans reach only this store).
The first site that finds the switch on after one found it off starts a
fresh store: each session reads its own spans. A session keeps at most
``CAP`` spans and counts the rest in ``trace.dropped``. No site reads a
device value, so none synchronises the card.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List

from torch.autograd import profiler as _profiler

CAP = 1 << 17

_lock = threading.Lock()
_local = threading.local()
_spans: List[list] = []  # [name, thread, parent record, request, t0, t1]
_counts: Dict[str, int] = {}
_stale = True  # a site found the switch off since the store was cleared


def on() -> bool:
    """True while a profiler session runs (the switch)."""
    return _profiler._is_profiler_enabled


def _fresh_locked():
    global _stale
    if _stale:
        _spans.clear()
        _counts.clear()
        _stale = False


class _Site:
    """A span site's name: what ``span`` returns while the switch is off
    (entering it does nothing), and a decorator that opens ``span(name)``
    around each call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced


_SITES: Dict[str, _Site] = {}


class _Span(_Site):
    __slots__ = ("request", "rec", "mark")

    def __init__(self, name: str, request):
        self.name, self.request = name, request

    def __enter__(self):
        from torch.profiler import record_function

        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        request = self.request
        if request is None and parent is not None:
            request = parent[3]
        self.mark = record_function(self.name)
        self.mark.__enter__()
        self.rec = [self.name, threading.current_thread().name, parent,
                    request, time.perf_counter_ns(), None]
        with _lock:
            _fresh_locked()
            if len(_spans) < CAP:
                _spans.append(self.rec)
            else:
                _counts["trace.dropped"] = _counts.get("trace.dropped",
                                                       0) + 1
        stack.append(self.rec)
        return self

    def __exit__(self, *exc):
        self.rec[5] = time.perf_counter_ns()
        _local.stack.pop()
        self.mark.__exit__(*exc)
        return False


def span(name: str, request=None):
    """A span named ``name``; ``request`` identifies a root span's request
    (a child inherits its parent's)."""
    if not _profiler._is_profiler_enabled:
        global _stale
        _stale = True
        return _SITES.get(name) or _SITES.setdefault(name, _Site(name))
    return _Span(name, request)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` (while the switch is on)."""
    if not _profiler._is_profiler_enabled:
        global _stale
        _stale = True
        return
    with _lock:
        _fresh_locked()
        _counts[name] = _counts.get(name, 0) + int(n)


def snapshot() -> Dict:
    """The store: ``spans`` (closed ones, in start order: ``name``,
    ``thread``, ``parent`` (an index into the list, or None), ``request``,
    ``start_ns``, ``end_ns``, ``self_ns``), ``counts``, and ``totals`` by
    span name (``n``, ``ms``, ``self_ms``)."""
    with _lock:
        recs = [r for r in _spans if r[5] is not None]
        counts = dict(_counts)
    index = {id(r): i for i, r in enumerate(recs)}
    parents = [index.get(id(r[2])) if r[2] is not None else None
               for r in recs]
    child_ns = [0] * len(recs)
    for r, p in zip(recs, parents):
        if p is not None:
            child_ns[p] += r[5] - r[4]
    spans, totals = [], {}
    for r, p, c in zip(recs, parents, child_ns):
        own = r[5] - r[4] - c
        spans.append({"name": r[0], "thread": r[1], "parent": p,
                      "request": r[3], "start_ns": r[4], "end_ns": r[5],
                      "self_ns": own})
        t = totals.setdefault(r[0], {"n": 0, "ms": 0.0, "self_ms": 0.0})
        t["n"] += 1
        t["ms"] += (r[5] - r[4]) * 1e-6
        t["self_ms"] += own * 1e-6
    return {"spans": spans, "counts": counts, "totals": totals}

