"""Host milliseconds the prefetch thread spends putting a batch on the
card (the port's span ``prefetch.put``: ``train_batch_to_device``) per
batch in the profiled sub-window. Moves ``train_ex_per_s``."""

from gpubench.spans import ms_per


def read(run):
    return ms_per(run, "prefetch.put", "prefetch.put")
