"""Megabytes the profiled VQA call copies to split its rows by segment
for the experts' GEMMs and to merge their outputs back (the port's
counter ``multiway.split_bytes``), per pair of the call. Lower is better.
Moves ``score_pairs_per_s``."""

from gpubench.spans import store


def read(run):
    snap = store(run)
    pairs = sum(w["pairs"] for w in run.prof_work) if run.prof_work else 0
    if not snap or not pairs or "multiway.split_bytes" not in snap["counts"]:
        return None
    return snap["counts"]["multiway.split_bytes"] / pairs / 1e6
