"""The FLOP the window's float32 scoring calls need
(``yardstick.score_call_work``: valid lengths, the CLS-only last layer),
over the window's wall time and the card's float32 peak (67 TFLOP/s:
``inf_itm`` keeps TF32 off, so the GEMMs run on the FP32 units), in %.
Moves ``score_pairs_per_s``."""

from gpubench.yardstick import PEAK_FP32


def read(run):
    flop = sum(w["flop"] for w in run.work)
    return 100.0 * flop / (run.window_s * PEAK_FP32) if flop else None
