"""The share of the residual + LayerNorm tails of the profiled scoring
call that ran as one fused kernel launch (the port's counters
``tail.fused`` and ``tail.plain``: one a tail, by the route it took), in
%. Moves ``score_pairs_per_s``."""

from gpubench.spans import store


def read(run):
    snap = store(run)
    if not snap:
        return None
    fused = snap["counts"].get("tail.fused", 0)
    total = fused + snap["counts"].get("tail.plain", 0)
    return 100.0 * fused / total if total else None
