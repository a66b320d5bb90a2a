"""K1's least time for the profiled float32 scoring call's attention
(layers 0..L-2 on every pair's valid positions) over its device time, in
%. The float32 K1 multiplies in three TF32 passes, so its peak is 495/3
TFLOP/s; q, k, v and out move 4 bytes an element, twice
``score_call_work``'s bf16 count (which counts the 4-byte key bias twice
too: 0.03% of the bytes at H 768). Moves ``score_pairs_per_s``."""

from gpubench.tracing import device_seconds
from gpubench.yardstick import bound_s

PEAK_TF32_3PASS = 495e12 / 3


def read(run):
    p = run.profile
    if not p or not run.prof_work:
        return None
    t = device_seconds(p, "mha_fwd_")
    if t <= 0:
        return None
    return 100.0 * bound_s(sum(w["k1_flop"] for w in run.prof_work),
                           2.0 * sum(w["k1_bytes"] for w in run.prof_work),
                           PEAK_TF32_3PASS) / t
