"""K1's least time for the profiled VQA call's attention (every layer on
each pair's valid positions, bf16 peak against HBM) over its device time
(``mha_fwd_`` kernels), in %. Moves ``score_pairs_per_s``."""

from gpubench.tracing import device_seconds
from gpubench.yardstick import PEAK_BF16, bound_s


def read(run):
    p = run.profile
    if not p or not run.prof_work:
        return None
    t = device_seconds(p, "mha_fwd_")
    if t <= 0:
        return None
    return 100.0 * bound_s(sum(w["k1_flop"] for w in run.prof_work),
                           sum(w["k1_bytes"] for w in run.prof_work),
                           PEAK_BF16) / t
