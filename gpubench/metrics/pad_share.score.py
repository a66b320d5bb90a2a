"""Padded token slots over all slots the profiled scoring call's tiles
compute (the port's counters ``itm.valid_slots`` and ``itm.slots``: text
lengths plus region counts of the real pairs, against T + R a pair of
every tile, rows repeated to fill a tile included), in %. Moves
``score_pairs_per_s``."""

from gpubench.spans import store


def read(run):
    snap = store(run)
    slots = snap["counts"].get("itm.slots") if snap else None
    if not slots:
        return None
    return 100.0 * (1.0 - snap["counts"].get("itm.valid_slots", 0) / slots)
