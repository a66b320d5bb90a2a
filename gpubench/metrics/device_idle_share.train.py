"""1 - device busy / wall over the profiled sub-window, in %: the share
of the card's time the host leaves it idle. Moves ``train_ex_per_s``."""


def read(run):
    p = run.profile
    if not p or not p["wall_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
