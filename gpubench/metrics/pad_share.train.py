"""Padded token slots over all slots of the window's batches (the valid
positions from ``attn_mask``), in %: work the bucket grid adds. Moves
``train_ex_per_s``."""


def read(run):
    slots = sum(w["slots"] for w in run.work)
    return 100.0 * (1.0 - sum(w["valid"] for w in run.work) / slots) \
        if slots else None
