"""What the readers of the port's own spans and counters share. A traced
run's profiled sub-window is a torch profiler session, which turns on the
port's store (``uniter_tpu_torch.utils.trace``): after the run it holds
that session's spans and counters. A reader returns None where the run
was not profiled, the port has no such store (a checkout from before it)
or the store is empty."""

from __future__ import annotations


def store(run):
    """The port's store after ``run``, or None."""
    if getattr(run, "profile", None) is None:
        return None
    try:
        from uniter_tpu_torch.utils import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    return snap if snap["spans"] or snap["counts"] else None


def ms_per(run, name: str, per: str):
    """Milliseconds of the spans ``name`` over the number of spans
    ``per``, or None where either is missing."""
    snap = store(run)
    if snap is None:
        return None
    t, n = snap["totals"].get(name), snap["totals"].get(per)
    return t["ms"] / n["n"] if t and n else None
