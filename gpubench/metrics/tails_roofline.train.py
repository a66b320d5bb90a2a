"""The fused tails' (K3-K6 and their ``sum_partials``) least time for the
profiled steps (bytes of the valid rows against fp32 operations,
``yardstick.tail_work``) over their device time, in %. Moves
``train_ex_per_s``."""

from gpubench.tracing import device_seconds
from gpubench.yardstick import PEAK_FP32, bound_s


def read(run):
    p = run.profile
    if not p or not run.prof_work:
        return None
    t = device_seconds(p, "tail_fwd", "tail_bwd", "sum_partials")
    if t <= 0:
        return None
    return 100.0 * bound_s(sum(w["tails_ops"] for w in run.prof_work),
                           sum(w["tails_bytes"] for w in run.prof_work),
                           PEAK_FP32) / t
