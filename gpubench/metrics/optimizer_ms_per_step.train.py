"""Host milliseconds of the optimizer's dispatch (the port's span
``optim.step``) per step (``loop.step``) in the profiled sub-window.
Moves ``train_ex_per_s``."""

from gpubench.spans import ms_per


def read(run):
    return ms_per(run, "optim.step", "loop.step")
