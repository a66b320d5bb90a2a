"""The training loops' shared core (``training/loop.py`` ``LoopCore``) on
the CPU, through each loop that runs it: ``TrainLoop``, ``MixedTaskLoop``
and ``train_itm_hard_negatives``'s ``HardNegLoop``. Each step's batch
carries the loss that step reports (a tiny model whose loss is that value
plus zero times its output), so a run's losses are known:

* five non-finite losses in a row make ``NanGuard`` raise
  ``FloatingPointError`` at the fifth one's step, and the run stops there
  (one alone resets the streak);
* each loss of an N-step run is read back and checked exactly once, in step
  order, also when ``bound_inflight`` reads the oldest ones early;
* ``finish_saves`` writes a new, blocking save unless the last periodic
  save was of the final step, which it then waits for.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from uniter_tpu_torch.training import loop as ploop

KINDS = ["train", "mixed", "hard_neg"]


class _Saver:
    def __init__(self):
        self.calls = []

    def save(self, step, state, seed, best_value=None, block=True):
        self.calls.append(("save", step, block))

    def wait(self):
        self.calls.append(("wait",))


def _loss(m, b, g):
    return m(b["x"]).sum() * 0 + b["v"][0], {}


def _loop(kind, losses, **kw):
    """A ``kind`` loop of ``len(losses)`` steps whose step i (from 1)
    reports ``losses[i - 1]``."""
    from uniter_tpu_torch.train_itm_hard_negatives import HardNegLoop
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training.step import TrainState, make_train_step

    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    state = TrainState(step=0, model=model, opt=popt.build_optimizer(
        model, 1e-3, fused=True))
    # the prefetch thread reads ahead of the last step
    batches = [{"x": np.ones((2, 3), np.float32),
                "v": np.full((1,), v, np.float32),
                "input_ids": np.zeros((2, 1), np.int32)}
               for v in losses + [0.0] * 4]
    common = dict(state=state, device="cpu", num_train_steps=len(losses),
                  preempt=False, **kw)
    if kind == "train":
        return ploop.TrainLoop(loss_fn=_loss, train_loader=batches, **common)
    step = make_train_step(_loss)
    if kind == "mixed":
        return ploop.MixedTaskLoop(
            meta=zip(itertools.repeat("mlm_a"), batches),
            get_step=lambda task: step, **common)
    return HardNegLoop(stream=iter(batches), step_fn=step, mined_per_step=4,
                       **common)


def _checked(monkeypatch):
    """The (step, loss) of each ``NanGuard.check``, in call order."""
    seen = []
    check = ploop.NanGuard.check

    def keep(self, value, step):
        seen.append((step, value))
        return check(self, value, step)

    monkeypatch.setattr(ploop.NanGuard, "check", keep)
    return seen


@pytest.mark.parametrize("kind", KINDS)
def test_five_non_finite_losses_in_a_row_abort_at_the_fifth(kind,
                                                            monkeypatch):
    nan, inf = float("nan"), float("inf")
    losses = [1.0, nan, 2.0, nan, inf, nan, nan, nan, 3.0, 4.0]
    seen = _checked(monkeypatch)
    lp = _loop(kind, losses, valid_steps=0, log_steps=1)
    with pytest.raises(FloatingPointError,
                       match="non-finite for 5 consecutive steps at step 8"):
        lp.run()
    assert [s for s, _ in seen] == list(range(1, 9))
    assert lp.state.step == 8  # step 9 never ran


@pytest.mark.parametrize("kind", KINDS)
def test_each_loss_is_read_back_once(kind, monkeypatch):
    """7 steps, a log boundary at 5, at most 2 unread steps: the early
    readbacks of ``bound_inflight`` and the flushes together check each
    step's loss once."""
    monkeypatch.setattr(ploop, "MAX_INFLIGHT_STEPS", 2)
    losses = [0.5 + i for i in range(7)]
    seen = _checked(monkeypatch)
    state = _loop(kind, losses, valid_steps=0, log_steps=5).run()
    assert state.step == 7
    assert seen == [(i + 1, v) for i, v in enumerate(losses)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("valid_steps,want", [
    (3, [("save", 3, False), ("save", 6, False), ("wait",)]),
    (4, [("save", 4, False), ("save", 6, True)])])
def test_finish_saves_writes_the_last_step_once(kind, valid_steps, want):
    saver = _Saver()
    validated = []
    state = _loop(kind, [1.0] * 6, valid_steps=valid_steps, log_steps=2,
                  saver=saver, validate_fn=lambda st, step: validated.append(
                      step) or {"r_mean": 0.5}).run()
    assert state.step == 6
    assert saver.calls == want
    assert validated == [s for _, s, *_ in want[:-1]]
