"""Host milliseconds the loop spends enqueueing a step's forward, backward
and update (the port's span ``loop.step``, ``optim.step`` within it) per
step in the profiled sub-window. Moves ``train_ex_per_s`` where the host
sets the pace."""

from gpubench.spans import ms_per


def read(run):
    return ms_per(run, "loop.step", "loop.step")
