"""Host milliseconds a scoring call spends building the dense text and
fp32 image arrays (the port's span ``itm.build_arrays``) per call
(``itm.score``) in the profiled sub-window. Moves ``score_pairs_per_s``."""

from gpubench.spans import ms_per


def read(run):
    return ms_per(run, "itm.build_arrays", "itm.score")
