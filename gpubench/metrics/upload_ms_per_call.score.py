"""Host milliseconds a scoring call spends putting the corpus on the card
(the port's span ``itm.upload``: the padded copy and bf16 cast of the
image features on the host, the copies and the embedding's dispatch) per
call (``itm.score``) in the profiled sub-window. Moves
``score_pairs_per_s``."""

from gpubench.spans import ms_per


def read(run):
    return ms_per(run, "itm.upload", "itm.score")
