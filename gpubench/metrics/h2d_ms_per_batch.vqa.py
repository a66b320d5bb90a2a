"""Host milliseconds of the prefetch thread's puts (the port's span
``prefetch.put``: pinning a call's pixels and questions and the copies to
the card) per served call (``infer.batch``) in the profiled sub-window.
Moves ``score_pairs_per_s``."""

from gpubench.spans import ms_per


def read(run):
    return ms_per(run, "prefetch.put", "infer.batch")
