"""Device operations (kernels, copies, sets) per optimizer step in the
profiled sub-window. Moves ``train_ex_per_s``: fusion and graphs lower it."""


def read(run):
    p = run.profile
    return p["ops_per_step"] if p and p["steps"] else None
