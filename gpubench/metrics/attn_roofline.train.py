"""K1 and K2's least time for the profiled steps' attention (valid
lengths, ``yardstick.attention_work``, bf16 peak against HBM) over their
device time, in %. Moves ``train_ex_per_s``."""

from gpubench.tracing import device_seconds
from gpubench.yardstick import PEAK_BF16, bound_s


def read(run):
    p = run.profile
    if not p or not run.prof_work:
        return None
    t = device_seconds(p, "mha_fwd_", "mha_bwd_", "dq_sum_kernel")
    if t <= 0:
        return None
    bound = sum(bound_s(sum(w[f"{k}_flop"] for w in run.prof_work),
                        sum(w[f"{k}_bytes"] for w in run.prof_work),
                        PEAK_BF16) for k in ("k1", "k2"))
    return 100.0 * bound / t
