"""Learning-rate schedules (counterpart of ``uniter_tpu/training/sched.py``,
reference optim/sched.py).

The reference pokes ``get_lr_sched(global_step)`` into its param groups
with global_step starting at 1; the optimizer here counts updates from 0,
so every schedule is evaluated at ``count + 1``, with the reference's 1e-8
floor (sched.py:40-46). Plain Python on host integers: the value enters
the update as one fp32 scalar.
"""

from __future__ import annotations

import math


def noam_schedule(step, warmup_step=4000):
    """Original Transformer schedule (sched.py:10-14)."""
    step = max(step, 1)
    if step <= warmup_step:
        return step / warmup_step
    return (warmup_step ** 0.5) * (step ** -0.5)


def warmup_linear(step, warmup_step, tot_step):
    """BERT schedule: linear warm-up, then linear decay (sched.py:17-21)."""
    if step < warmup_step:
        return step / max(warmup_step, 1)
    return max(0.0, (tot_step - step) / max(tot_step - warmup_step, 1))


def vqa_schedule(step, warmup_interval, decay_interval, decay_start,
                 decay_rate):
    """MCAN step schedule (sched.py:24-37; defined but unused by the
    reference drivers)."""
    if step < warmup_interval:
        return 0.25
    if step < 2 * warmup_interval:
        return 0.5
    if step < 3 * warmup_interval:
        return 0.75
    if step >= decay_start:
        return decay_rate ** math.ceil((step - decay_start) / decay_interval)
    return 1.0


def get_lr_schedule(learning_rate: float, warmup_steps: int,
                    num_train_steps: int):
    """schedule(count) -> lr, reproducing get_lr_sched (sched.py:40-46)."""

    def schedule(count):
        step = int(count) + 1  # reference global_step starts at 1
        lr = learning_rate * warmup_linear(step, warmup_steps,
                                           num_train_steps)
        return max(lr, 1e-8)

    return schedule
