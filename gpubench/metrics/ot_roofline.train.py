"""K7's least time for the profiled ITM steps' valid plans
(``yardstick.ipot_work``) over its device time, in %. Moves
``train_ex_per_s``."""

from gpubench.tracing import device_seconds
from gpubench.yardstick import PEAK_FP32, bound_s


def read(run):
    p = run.profile
    if not p:
        return None
    work = [w for w in run.prof_work if "ot_ops" in w]
    t = device_seconds(p, "ipot_reg_kernel", "ipot_mem_kernel")
    if not work or t <= 0:
        return None
    return 100.0 * bound_s(sum(w["ot_ops"] for w in work),
                           sum(w["ot_bytes"] for w in work), PEAK_FP32) / t
