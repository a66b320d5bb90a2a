"""The FLOP the window's VQA calls need (``beit3_work.vqa_call_work``:
valid lengths, the patch convolution once an image), over the window's
wall time and the card's bf16 peak, in %. Moves ``score_pairs_per_s``."""

from gpubench.yardstick import PEAK_BF16


def read(run):
    flop = sum(w["flop"] for w in run.work)
    return 100.0 * flop / (run.window_s * PEAK_BF16) if flop else None
