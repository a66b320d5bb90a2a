"""Image-text retrieval fine-tuning with online hard-negative mining on one
device (counterpart of the root ``train_itm_hard_negatives.py``, reference
train_itm_hard_negatives.py):

    python -m uniter_tpu_torch.train_itm_hard_negatives --config CONFIG.json \\
        [--device cuda] [--num_train_steps N] ...

Each candidate batch holds one positive and ``negative_size`` negatives
sharing its text (``ItmRankDatasetHardNegFromText``) or its image
(``...FromImage``); the two streams alternate, image side first. The model
scores every candidate without gradient, mines the top ``hard_neg_size``
and trains on [pos + hard] (model/itm.py:58-139). One optimizer step sums
the gradients of ``train_batch_size`` candidate batches
(``make_train_step(loss_scale="mean", accum_steps=train_batch_size)``).
A rerun resumes and fast-forwards both mining streams past the batches the
interrupted run consumed. Over N processes (``torchrun``) every rank
builds the same candidate batches and takes its block of
``train_batch_size / N`` of each step's stack (mining needs a candidate
batch whole, so the accumulation axis is what is split; the JAX driver's
``local=False``, ``train_itm_hard_negatives.py:161-167``). Logs
``perf/hn_per_s`` (mined negatives per second) every ``log_steps``;
validates (windowed recall) and saves every ``valid_steps``.
"""

from __future__ import annotations

import argparse
import itertools
import time

import numpy as np
import torch

from uniter_tpu_torch import train_itm
from uniter_tpu_torch.data.itm import (
    ItmRankDatasetHardNegFromImage, ItmRankDatasetHardNegFromText,
    hard_neg_collate)
from uniter_tpu_torch.models.itm import UniterForImageTextRetrievalHardNeg
from uniter_tpu_torch.parallel.collectives import num_processes
from uniter_tpu_torch.training import driver
from uniter_tpu_torch.training.optim import build_optimizer
from uniter_tpu_torch.training.sched import get_lr_schedule
from uniter_tpu_torch.training.step import TrainState, make_train_step
from uniter_tpu_torch.utils.logger import LOGGER, TB_LOGGER
from uniter_tpu_torch.utils.misc import parse_with_config
from uniter_tpu_torch.utils.save import TrainStateSaver


class HnLoader:
    """One fixed-shape candidate batch per example, forever. One draw from
    the loader's generator seeds each record, so ``skip_batches`` is an
    exact resume fast-forward that fetches nothing."""

    def __init__(self, ds, t_bucket, r_bucket, seed):
        self.ds = ds
        self.t_bucket = t_bucket
        self.r_bucket = r_bucket
        self.rng = np.random.RandomState(seed)
        self.order = np.arange(len(ds))
        self.rng.shuffle(self.order)
        self._pos = 0

    def _advance(self):
        if self._pos >= len(self.order):
            self.rng.shuffle(self.order)
            self._pos = 0
        i = int(self.order[self._pos])
        self._pos += 1
        return i, int(self.rng.randint(2 ** 31))

    def skip_batches(self, n: int):
        for _ in range(int(n)):
            self._advance()

    def __iter__(self):
        return self

    def __next__(self):
        i, rec_seed = self._advance()
        rec = self.ds.get_record(i, np.random.RandomState(rec_seed))
        return hard_neg_collate(rec, self.t_bucket, self.r_bucket)


def stacked_batches(loader_i, loader_t, accum: int, n_consumed: int):
    """[accum / N, rows, ...] stacks of candidate batches: of each step's
    ``accum``, alternating image side and text side (continuing the
    alternation after a resume), this rank's block of the N processes'; a
    block of one is the batch itself (the step's ``accum_steps=1``
    layout)."""
    from uniter_tpu_torch.parallel.collectives import (
        num_processes, process_index)

    sources = itertools.cycle([loader_i, loader_t])
    if n_consumed % 2:
        next(sources)
    local = accum // num_processes()
    lo = process_index() * local
    while True:
        batches = [next(next(sources)) for _ in range(accum)][lo:lo + local]
        yield {k: (np.stack([b[k] for b in batches]) if local > 1
                   else batches[0][k])
               for k in batches[0] if isinstance(batches[0][k], np.ndarray)}


def hard_neg_loss(model, batch, generator):
    """Mean triplet loss of one mined candidate batch (and no metrics);
    over N processes its share 1/N, with the step's ``loss_scale="sum"``
    restoring the gradient of each candidate batch."""
    from uniter_tpu_torch.parallel.collectives import num_processes

    loss = model(batch, True, deterministic=False, generator=generator).mean()
    world = num_processes()
    return (loss / world if world > 1 else loss), {}


def main(opts):
    from uniter_tpu_torch.data.loader import DevicePrefetcher
    from uniter_tpu_torch.data.txt_db import TxtTokDb
    from uniter_tpu_torch.training.loop import (
        NanGuard, bound_inflight, finish_saves, train_batch_to_device,
        warn_preempted)
    from uniter_tpu_torch.training.preempt import PreemptionGuard

    if (opts.negative_size + 1) % 8:
        raise ValueError("candidate count (negative_size + 1) must be a "
                         "multiple of 8 (reference :438 tensor-core rule)")
    cfg = driver.model_config_from_opts(opts)
    driver.setup_run(opts, cfg)
    world = num_processes()
    if opts.train_batch_size % world:
        raise ValueError(f"train_batch_size {opts.train_batch_size} "
                         f"candidate batches do not split over {world} "
                         "processes")
    model = train_itm.build_model(opts, cfg,
                                  cls=UniterForImageTextRetrievalHardNeg,
                                  hard_size=opts.hard_neg_size)

    # reference HN configs declare single-element db LISTS
    txt_db = TxtTokDb((opts.train_txt_dbs or [opts.train_txt_db])[0],
                      max_txt_len=opts.max_txt_len)
    img_db = driver.open_img_db((opts.train_img_dbs or
                                 [opts.train_img_db])[0], opts)
    kw = dict(neg_sample_size=opts.negative_size)
    t_bucket, r_bucket = opts.txt_bucket, opts.img_bucket
    loader_t = HnLoader(ItmRankDatasetHardNegFromText(txt_db, img_db, **kw),
                        t_bucket, r_bucket, opts.seed)
    loader_i = HnLoader(ItmRankDatasetHardNegFromImage(txt_db, img_db, **kw),
                        t_bucket, r_bucket, opts.seed + 1)
    val_ds = train_itm.build_val_dataset(opts)

    sched = get_lr_schedule(opts.learning_rate, opts.warmup_steps,
                            opts.num_train_steps)
    state = TrainState(step=0, model=model, opt=build_optimizer(
        model, sched, **driver.optim_kwargs(opts)))
    saver = TrainStateSaver(opts.output_dir)
    if saver.restore(state, seed=opts.seed) is not None:
        LOGGER.info("resumed from step %d", state.step)
    # each step consumed train_batch_size candidate batches, strictly
    # alternating image side / text side (image side first), so the two
    # streams split ceil / floor
    n_consumed = state.step * opts.train_batch_size
    if n_consumed:
        loader_i.skip_batches((n_consumed + 1) // 2)
        loader_t.skip_batches(n_consumed // 2)
        LOGGER.info("resumed from step %d: fast-forwarded mining streams "
                    "by %d candidate batches", state.step, n_consumed)

    # loss_scale "sum" x the 1/N share = the one-process "mean" step
    step = make_train_step(hard_neg_loss, loss_scale="sum",
                           accum_steps=opts.train_batch_size // world)
    device, cdt = torch.device(opts.device), cfg.compute_dtype
    it = DevicePrefetcher(
        stacked_batches(loader_i, loader_t, opts.train_batch_size,
                        n_consumed),
        lambda b: train_batch_to_device(
            b, device, None if cdt == torch.float32 else cdt,
            driver.wire_codec(opts)), depth=2)
    guard = NanGuard()
    pending = []
    last_saved = -1
    t_window, window_start = time.time(), state.step

    def flush():
        for s, dev_loss in pending:
            val = float(dev_loss)
            guard.check(val, s)
            TB_LOGGER.add_scalar("loss", val, s)
        pending.clear()

    try:
        with PreemptionGuard() as preempt:
            while state.step < opts.num_train_steps:
                state, metrics = step(state, next(it), opts.seed)
                pending.append((state.step, metrics["loss"]))
                bound_inflight(pending)
                if state.step % opts.log_steps == 0:
                    flush()
                    # reference telemetry (train_itm_hard_negatives.py:
                    # 228-237): mined hard negatives consumed per second
                    hn = ((state.step - window_start) * opts.train_batch_size
                          * opts.hard_neg_size)
                    TB_LOGGER.add_scalar("perf/hn_per_s",
                                         hn / (time.time() - t_window),
                                         state.step)
                    t_window, window_start = time.time(), state.step
                if opts.valid_steps and state.step % opts.valid_steps == 0:
                    flush()
                    logs = train_itm.validate_retrieval(state.model, val_ds)
                    LOGGER.info("step %d: r_mean %.4f", state.step,
                                logs["r_mean"])
                    TB_LOGGER.log_scalar_dict(
                        {f"valid/{k}": v for k, v in logs.items()},
                        step=state.step)
                    saver.save(state.step, state, opts.seed, block=False)
                    last_saved = state.step
                if preempt.poll():
                    flush()
                    warn_preempted(state.step, opts.num_train_steps, True)
                    break
            flush()
            finish_saves(saver, state, opts.seed, last_saved)
    finally:
        it.close()
    LOGGER.info("training finished at step %d", state.step)
    return state


def get_parser():
    parser = argparse.ArgumentParser()
    driver.add_common_args(parser)
    parser.add_argument("--train_txt_db", type=str)
    parser.add_argument("--train_img_db", type=str)
    parser.add_argument("--train_txt_dbs", type=str, nargs="*", default=None)
    parser.add_argument("--train_img_dbs", type=str, nargs="*", default=None)
    parser.add_argument("--val_txt_db", type=str)
    parser.add_argument("--val_img_db", type=str)
    parser.add_argument("--negative_size", type=int, default=511)
    parser.add_argument("--hard_neg_size", type=int, default=31)
    parser.add_argument("--margin", type=float, default=0.2)
    parser.add_argument("--inf_minibatch_size", type=int, default=400)
    parser.add_argument("--txt_bucket", type=int, default=64)
    parser.add_argument("--img_bucket", type=int, default=64)
    parser.set_defaults(learning_rate=5e-5, num_train_steps=5000,
                        warmup_steps=500, train_batch_size=8)
    return parser


if __name__ == "__main__":
    main(parse_with_config(get_parser()))
