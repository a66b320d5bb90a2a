"""The fused tails' least time in the profiled VQA call (the multiway
K3/K5 launches and the pooler's K5: their bytes from valid lengths,
``beit3_work``, at 3.35 TB/s) over their device time (``tail_fwd``
kernels), in %. Moves ``score_pairs_per_s``."""

from gpubench.tracing import device_seconds
from gpubench.yardstick import HBM_BYTES_PER_S


def read(run):
    p = run.profile
    if not p or not run.prof_work:
        return None
    t = device_seconds(p, "tail_fwd")
    if t <= 0:
        return None
    nbytes = sum(w["tails_bytes"] for w in run.prof_work)
    return 100.0 * nbytes / HBM_BYTES_PER_S / t
