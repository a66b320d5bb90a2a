"""The FLOP the window's forward and backward passes need (``yardstick``:
valid lengths, backward twice the forward), over the window's wall time
and the card's bf16 peak, in %. Moves ``train_ex_per_s``."""

from gpubench.yardstick import PEAK_BF16


def read(run):
    flop = sum(w["flop"] for w in run.work)
    return 100.0 * flop / (run.window_s * PEAK_BF16) if flop else None
