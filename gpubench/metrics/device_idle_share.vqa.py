"""1 - device busy / wall over the profiled VQA call, in %: the share of
the card's time the host (the question collate, the pixels' upload, the
dispatch, the answers' readback) leaves it idle. Moves
``score_pairs_per_s``."""


def read(run):
    p = run.profile
    if not p or not p["wall_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
