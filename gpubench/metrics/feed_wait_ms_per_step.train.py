"""Host milliseconds the loop's thread waits on the prefetch queue (the
port's span ``loop.feed_wait``) per step (``loop.step``) in the profiled
sub-window. Moves ``train_ex_per_s`` where the card waits for the feed."""

from gpubench.spans import ms_per


def read(run):
    return ms_per(run, "loop.feed_wait", "loop.step")
