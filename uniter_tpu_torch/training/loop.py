"""The hot loops (counterpart of ``uniter_tpu/training/loop.py``): the
fine-tune ``TrainLoop`` (reference train_nlvr2.py:55-276) and the
pretraining ``MixedTaskLoop`` (reference pretrain.py:255-365), both, and
``train_itm_hard_negatives.py``'s loop, one ``LoopCore`` that each gives
only what is its own.

Step-based loop over an infinite bucketed loader, each batch copied to the
device by the ``DevicePrefetcher`` thread (pinned, non-blocking) while the
previous step computes; EMA loss meter and the reference's scalar names
(``loss``, ``lr``, ``grad_norm``, ``perf/ex_per_s``, ``valid/*``);
validation and checkpoints at ``valid_steps``, with the best export of a
validation metric (``best_metric``) written by the same save; resume with
the loader fast-forwarded past the batches the interrupted run consumed;
SIGTERM preemption (checkpoint and clean exit).

Over several processes (``torchrun``) every rank runs the loop in
lockstep on its block of each global batch: the step sums the gradients
and reports the global loss (``training/step.py``), every rank validates
its share of the evaluation set and ``validate_fn`` gathers the result, so
the best-checkpoint decision is one value on every rank (under ``--fsdp``
with the parameters gathered once around it, ``parallel.fsdp
.local_params``); each rank joins
the saves' gathers and rank 0 writes, logs and profiles; the preemption
guard agrees on the stop step (``training/preempt.py``).

Loss readback is deferred to the log boundaries: ``float(loss)`` every
step would make the host wait for the card each step. ``bound_inflight``
still caps how many unread steps pile up. The JAX loop's ahead-of-time
compile of every bucket (``--warmup_compile``) and its mesh placement of
batches have no counterpart on one eager device.

The loops take the JAX loops' ``wire_codec`` (``"int8"``: ``img_feat``
crosses to the card as per-row int8 and an fp32 scale, dequantized there;
JAX ``loop.py:95-180``) and ``profile_dir`` (a ``torch.profiler`` trace of
one window of steps, ``ProfileWindow``; JAX ``loop.py:204-210``), and
save asynchronously at their periodic saves (``TrainStateSaver.save(...,
block=False)``: the host copy is taken before the call returns, the disk
write runs in a thread); the final save blocks.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from uniter_tpu_torch.parallel.fsdp import local_params
from uniter_tpu_torch.training.step import TrainState, make_train_step
from uniter_tpu_torch.utils import trace
from uniter_tpu_torch.utils.logger import LOGGER, RunningMeter, TB_LOGGER

MAX_INFLIGHT_STEPS = int(os.environ.get("UNITER_MAX_INFLIGHT_STEPS", "16"))

# Inputs the model casts to its compute dtype first thing (the image
# embeddings): cast on the host when that shrinks the bytes copied to the
# card (fp32 -> bf16); the stores' fp16 features already travel at 2 bytes.
TRANSFER_CAST_KEYS = ("img_feat", "img_pos_feat")
# Fields the int8 wire codec carries (the largest wire bytes).
WIRE_INT8_KEYS = ("img_feat",)


def quantize_wire_int8(v: np.ndarray):
    """Per-row symmetric int8 of [..., D] features (JAX
    ``_quantize_wire_int8``): ``q * scale`` reconstructs ``v`` within
    max|row| / 254; the scales are fp32 [..., 1], floored at 1e-12."""
    scale = np.abs(v).max(axis=-1, keepdims=True).astype(np.float32) / 127.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_wire_int8(q: torch.Tensor, scale: torch.Tensor, dtype):
    """``q * scale`` in ``dtype``, on their device (JAX ``_dequant_q8``:
    both cast to ``dtype`` first)."""
    return q.to(dtype) * scale.to(dtype)


def bound_inflight(pending):
    """Cap unread steps by reading back the OLDEST pending loss in place
    (entries are tuples whose last element is the device value)."""
    if MAX_INFLIGHT_STEPS and len(pending) >= MAX_INFLIGHT_STEPS:
        e = pending[0]
        if isinstance(e[-1], torch.Tensor):
            with trace.span("loop.readback"):
                pending[0] = (*e[:-1], e[-1].cpu().numpy())


def _crossed(step: int, k: int, every: int) -> bool:
    """True when [step-k, step] crossed a multiple of ``every`` (with
    steps_per_call k > 1, exact equality would skip boundaries)."""
    return step // every > (step - k) // every


class NanGuard:
    """Abort after ``limit`` consecutive non-finite losses (checked at flush
    boundaries on the deferred values; the last good checkpoint stays
    resumable)."""

    def __init__(self, limit: int = 5):
        self.limit = limit
        self.streak = 0

    def check(self, loss_val: float, step: int):
        if np.isfinite(loss_val):
            self.streak = 0
            return
        self.streak += 1
        LOGGER.warning("non-finite loss at step %d (%d consecutive)",
                       step, self.streak)
        if self.streak >= self.limit:
            raise FloatingPointError(
                f"loss non-finite for {self.streak} consecutive steps at "
                f"step {step} — aborting (last good checkpoint is resumable)")


def train_batch_to_device(batch, device, transfer_dtype=None,
                          wire_codec=None):
    """The numpy arrays of a (possibly stacked) batch as device tensors,
    with the host cast of ``TRANSFER_CAST_KEYS`` to ``transfer_dtype``.
    ``wire_codec="int8"`` ships the float ``WIRE_INT8_KEYS`` as int8 and
    scale instead and dequantizes them on the device to ``transfer_dtype``
    (fp32 when None): lossy (~0.4% of a row's largest value), for hosts
    whose copy to the card is the limit; the default path is bit-exact."""
    from uniter_tpu_torch.training.infer import to_device

    if wire_codec not in (None, "int8"):
        raise ValueError(f"unknown wire_codec {wire_codec!r}")
    host, quant = {}, []
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            continue
        if (wire_codec == "int8" and k in WIRE_INT8_KEYS
                and np.issubdtype(v.dtype, np.floating)):
            q, scale = quantize_wire_int8(v)
            host[k] = torch.from_numpy(q)
            host[k + "/scale"] = torch.from_numpy(scale)
            quant.append(k)
            continue
        t = torch.from_numpy(v)
        if (transfer_dtype is not None and k in TRANSFER_CAST_KEYS
                and t.is_floating_point()
                and t.element_size() > transfer_dtype.itemsize):
            t = t.to(transfer_dtype)
        host[k] = t
    out = to_device(host, device)
    for k in quant:
        out[k] = dequantize_wire_int8(out[k], out.pop(k + "/scale"),
                                      transfer_dtype or torch.float32)
    return out


# The profiled steps (JAX ``loop.py`` ``profile_steps`` default).
PROFILE_STEPS = (10, 15)


def _clamp_profile(num_train_steps):
    """Fit ``PROFILE_STEPS`` inside the run (JAX ``_clamp_profile``: a
    short run would never reach 10-15)."""
    start, stop = PROFILE_STEPS
    stop = min(stop, max(num_train_steps - 2, 0))
    start = min(start, max(stop - 1, 0))
    return (start, stop)


class ProfileWindow:
    """``--profile_dir``: ``torch.profiler`` (CPU, and CUDA on the card)
    over the steps from the first at or past ``PROFILE_STEPS[0]`` until
    one past ``PROFILE_STEPS[1]``, clamped to the run;
    ``tensorboard_trace_handler`` writes the trace (``*.pt.trace.json``)
    into ``profile_dir`` when the window closes, once a run. A resumed run profiles from 2 steps after its
    start, the same span (JAX ``loop.py:381-384``). The session turns on
    the port's spans (``utils/trace.py``): each profiled step is a
    ``loop.step`` range in the trace, and closing the window logs each
    span name's count, total and self milliseconds, the prefetch thread's
    too. Over several processes rank 0 alone profiles."""

    def __init__(self, profile_dir: Optional[str], num_train_steps, device):
        from uniter_tpu_torch.parallel.collectives import process_index

        self.dir = profile_dir if process_index() == 0 else None
        self.steps = _clamp_profile(num_train_steps)
        self.device = torch.device(device)
        self.prof = None

    def resume(self, start_step: int):
        span = self.steps[1] - self.steps[0]
        self.steps = (start_step + 2, start_step + 2 + span)

    def begin(self, step: int):
        """Before the step that follows ``step`` steps."""
        if self.dir is None:
            return
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        if self.prof is None and step >= self.steps[0]:
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts,
                                on_trace_ready=tensorboard_trace_handler(
                                    self.dir))
            self.prof.start()

    def end(self, step: int):
        """After the step that brought the count to ``step``."""
        if self.prof is not None and step > self.steps[1]:
            self.close()

    def close(self):
        """Write the trace of an open window (the card's work finished
        first) and profile no more."""
        if self.prof is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.prof.stop()
            LOGGER.info("profiler trace written to %s", self.dir)
            for name, t in sorted(trace.snapshot()["totals"].items()):
                LOGGER.info("span %s: %d, %.3f ms, self %.3f ms", name,
                            t["n"], t["ms"], t["self_ms"])
        self.prof = None
        self.dir = None


def summed(counts: dict) -> dict:
    """Host counts summed key by key over the ranks (one host gather, at a
    log boundary): the global batch's examples, whatever share of its
    padding each rank's block holds. ``counts`` as it is in one
    process."""
    from uniter_tpu_torch.parallel.collectives import (
        all_gather_list, data_group)

    ranks = all_gather_list(counts, data_group())
    return {k: sum(r[k] for r in ranks) for k in counts}


def finish_saves(saver, state, seed: int, last_saved: int):
    """The run's last save, blocking: a new one unless the last periodic
    save was of this step, which is then waited for. Every rank returns
    once the files are on disk."""
    from uniter_tpu_torch.parallel.collectives import barrier

    if saver is None:
        return
    if last_saved != state.step:
        saver.save(state.step, state, seed)
    else:
        saver.wait()
    barrier()


class LoopCore:
    """The sequence every training loop runs, held once: each item copied
    to the device by the prefetch thread (``DevicePrefetcher``), the step,
    the deferred loss readback checked by ``NanGuard``, the log
    boundaries, validation under ``local_params`` with the best export of
    ``best_metric``, the asynchronous periodic save, the preemption stop
    and the final save (``finish_saves``); the ``loop.feed_wait``,
    ``loop.step`` and ``loop.readback`` spans and the ``--profile_dir``
    window. A loop supplies what is its own: the items (``_source()``),
    what the prefetch thread counts of each (``_host``), the step that runs
    it (``_take``), how a read-back loss is metered (``_meter(step, tag,
    value)``), what a log boundary writes (``_log(step, metrics)``) and a
    validation logs (``_log_valid``), how a resume fast-forwards
    (``_resume``), and ``k``, the steps one call advances."""

    k = 1
    best_metric: Optional[str] = None
    best_value: Optional[float] = None

    def __init__(
        self,
        *,
        state: TrainState,
        device,
        num_train_steps: int,
        valid_steps: int = 1000,
        log_steps: int = 100,
        validate_fn: Optional[Callable] = None,  # (state, step) -> dict
        saver=None,
        seed: int = 0,
        transfer_dtype=None,
        preempt=True,
        lr_schedule=None,
        wire_codec: Optional[str] = None,
        profile_dir: Optional[str] = None,
    ):
        self.state = state
        self.device = torch.device(device)
        self.num_train_steps = num_train_steps
        self.valid_steps = valid_steps
        self.log_steps = log_steps
        self.validate_fn = validate_fn
        self.saver = saver
        self.seed = seed
        self.transfer_dtype = transfer_dtype
        self.lr_schedule = lr_schedule
        self.wire_codec = wire_codec
        self.window = ProfileWindow(profile_dir, num_train_steps, device)
        if preempt is True:
            from uniter_tpu_torch.training.preempt import PreemptionGuard

            preempt = PreemptionGuard()
        self.preempt = preempt or None
        self.preempted = False
        self._it = None

    def _resume(self, step: int):
        """Fast-forward the items past the ``step`` steps already taken."""

    def _host(self, item):
        """On the prefetch thread: (host counts, host batch) of an item."""
        return None, item

    def _take(self, info):
        """(step function, meter tag) of an item, given its host counts."""
        return self.step_fn, None

    def _log_valid(self, step: int, logs: dict):
        """The log line of a validation, if the loop writes one."""

    def _put(self, item):
        info, batch = self._host(item)
        return info, train_batch_to_device(batch, self.device,
                                           self.transfer_dtype,
                                           self.wire_codec)

    def run(self) -> TrainState:
        try:
            with self.preempt or contextlib.nullcontext():
                return self._run()
        finally:
            self.window.close()
            if self._it is not None:
                self._it.close()
            self._it = None

    def _run(self):
        from uniter_tpu_torch.data.loader import DevicePrefetcher

        state = self.state
        guard = NanGuard()
        step = state.step
        if step > 0:
            self._resume(step)
            self.window.resume(step)
        self.t_start, self.start_step = time.time(), step
        self._it = it = DevicePrefetcher(iter(self._source()), self._put,
                                         depth=2)
        last_saved = -1
        pending = []  # (first step, meter tag, loss tensor or [k])

        def flush():
            with trace.span("loop.readback"):
                for s0, tag, dev_loss in pending:
                    vals = np.asarray(dev_loss.cpu() if isinstance(
                        dev_loss, torch.Tensor) else dev_loss).reshape(-1)
                    for j, v in enumerate(vals):
                        guard.check(float(v), s0 + j)
                        self._meter(s0 + j, tag, float(v))
            pending.clear()

        while step < self.num_train_steps:
            with trace.span("loop.feed_wait", request=step):
                info, batch = next(it)
            step_fn, tag = self._take(info)
            self.window.begin(step)
            with trace.span("loop.step", request=step):
                state, metrics = step_fn(state, batch, self.seed)
            pending.append((step + 1, tag, metrics["loss"]))
            bound_inflight(pending)
            step += self.k
            self.window.end(step)
            if _crossed(step, self.k, self.log_steps):
                flush()
                self._log(step, metrics)
            if self.valid_steps and _crossed(step, self.k, self.valid_steps):
                flush()
                improved = None
                if self.validate_fn is not None:
                    with local_params(state.model):
                        logs = self.validate_fn(state, step)
                    if logs:
                        self._log_valid(step, logs)
                        TB_LOGGER.log_scalar_dict(
                            {f"valid/{k}": v for k, v in logs.items()},
                            step=step)
                    if self.best_metric and logs and self.best_metric in logs:
                        v = float(logs[self.best_metric])
                        if self.best_value is None or v > self.best_value:
                            self.best_value = improved = v
                if self.saver is not None:
                    # an improvement rides the same save as
                    # model_step_best.pt; the write overlaps training
                    self.saver.save(step, state, self.seed,
                                    best_value=improved, block=False)
                    last_saved = step
            if self.preempt is not None and self.preempt.poll():
                flush()
                self.preempted = True
                LOGGER.warning(
                    "preempted at step %d/%d — %s", step, self.num_train_steps,
                    "saving resumable checkpoint and exiting (rerun the same "
                    "command to resume)" if self.saver is not None else
                    "exiting WITHOUT a checkpoint (no saver configured)")
                break
        flush()
        assert step == state.step
        finish_saves(self.saver, state, self.seed, last_saved)
        self.state = state
        return state


class TrainLoop(LoopCore):
    """The fine-tune loop (reference train_nlvr2.py:55-276): one step
    function over an infinite bucketed loader, grouped by
    ``AccumLoader`` for accumulation or ``steps_per_call`` k; one EMA loss
    meter and the reference's ``loss``, ``grad_norm``, ``lr`` and
    ``perf/ex_per_s``; resume with ``skip_batches(step // k)``."""

    def __init__(
        self,
        *,
        loss_fn: Callable,  # (model, batch, generator) -> (scalar, metrics)
        train_loader: Iterable,
        gradient_accumulation_steps: int = 1,
        loss_scale: str = "sum",
        steps_per_call: int = 1,
        best_metric: Optional[str] = None,
        best_value: Optional[float] = None,
        **kw,
    ):
        super().__init__(**kw)
        num_train_steps = self.num_train_steps
        self.train_loader = train_loader
        self._base_loader = train_loader
        self.accum = gradient_accumulation_steps
        self.k = steps_per_call
        # best-checkpoint tracking on a validation metric (reference
        # train_re.py:259-263): best_value seeds the running max (a resumed
        # run passes the saved value, a fresh one None)
        self.best_metric = best_metric
        self.best_value = best_value
        if self.k > 1 and num_train_steps % self.k:
            LOGGER.warning(
                "steps_per_call=%d does not divide num_train_steps=%d: the "
                "run stops at step %d", self.k, num_train_steps,
                ((num_train_steps + self.k - 1) // self.k) * self.k)
        if self.accum > 1 or self.k > 1:
            from uniter_tpu_torch.data.loader import AccumLoader

            self.train_loader = AccumLoader(train_loader,
                                            max(self.accum, self.k))
        self.step_fn = make_train_step(
            loss_fn, loss_scale=loss_scale, accum_steps=self.accum,
            steps_per_call=self.k)
        self.meter = RunningMeter("loss")
        self.n_examples = 0

    def _resume(self, step):
        LOGGER.info("resuming from step %d", step)
        if hasattr(self._base_loader, "skip_batches"):
            # one stacked batch serves k steps; AccumLoader converts
            self.train_loader.skip_batches(step // self.k)
            LOGGER.info("fast-forwarded train loader to step %d", step)

    def _source(self):
        return self.train_loader

    def _host(self, batch):
        return int(batch.get("ex_weight", np.ones(
            batch["input_ids"].shape[:-1])).sum()), batch

    def _take(self, n_ex):
        self.n_examples += n_ex
        return self.step_fn, None

    def _meter(self, step, tag, value):
        self.meter(value)

    def _log(self, step, metrics):
        ex_per_s = (summed({"ex": self.n_examples})["ex"]
                    / (time.time() - self.t_start))
        TB_LOGGER.add_scalar("loss", self.meter.val, step)
        TB_LOGGER.add_scalar("grad_norm", float(metrics["grad_norm"]), step)
        if self.lr_schedule is not None:
            TB_LOGGER.add_scalar("lr", float(self.lr_schedule(step)), step)
        TB_LOGGER.add_scalar("perf/ex_per_s", ex_per_s, step)
        LOGGER.info("step %d/%d loss %.4f (%.1f ex/s)", step,
                    self.num_train_steps, self.meter.val or 0.0, ex_per_s)


def pretrain_loss_units(task: str, batch) -> int:
    """Per-task loss-unit counts (the reference's n_loss_units,
    pretrain.py:266-293): masked tokens (mlm), masked regions (mrm),
    examples (itm)."""
    if task == "mlm":
        return int((batch["mlm_tgt"] != -1).sum())
    if task.startswith("mr"):
        return int(batch["mrm_valid"].sum())
    return int(batch["ex_weight"].sum())


class MixedTaskLoop(LoopCore):
    """The pretraining loop (reference pretrain.py:255-365): (task, batch)
    pairs from a ``MetaLoader``, one step function per task, a loss meter
    per task and the reference's throughput scalars
    (``perf/{name}_ex_per_s``, ``_in_per_s``, ``_loss_per_s``); resume by
    replaying the task draws (``meta.skip_steps``)."""

    def __init__(
        self,
        *,
        meta: Iterable,  # yields (name, batch) forever
        get_step: Callable[[str], Callable],  # task -> step function
        loss_units_fn: Optional[Callable] = None,  # (task, batch) -> int
        **kw,
    ):
        super().__init__(**kw)
        self.meta = meta
        self.get_step = get_step
        self.loss_units_fn = loss_units_fn
        self.task2loss: Dict[str, RunningMeter] = {}
        # name -> [examples, input units, loss units]
        self.counts: Dict[str, list] = {}

    def _resume(self, step):
        LOGGER.info("resuming from step %d", step)
        # replay the task draws and skip each task loader's consumed
        # batches (no record fetches)
        if hasattr(self.meta, "skip_steps"):
            self.meta.skip_steps(step)
            LOGGER.info("fast-forwarded task mix by %d steps", step)

    def _source(self):
        return self.meta

    def _host(self, item):
        name, batch = item
        n_ex = (int(batch["ex_weight"].sum()) if "ex_weight" in batch
                else int(batch["input_ids"].shape[0]))
        n_in = int(batch["attn_mask"].sum()) if "attn_mask" in batch else n_ex
        n_loss = (int(self.loss_units_fn(name.split("_")[0], batch))
                  if self.loss_units_fn is not None else n_ex)
        return (name, (n_ex, n_in, n_loss)), batch

    def _take(self, info):
        name, counts = info
        self.counts[name] = [a + b for a, b in zip(
            self.counts.get(name, (0, 0, 0)), counts)]
        return self.get_step(name.split("_")[0]), name

    def _meter(self, step, name, value):
        self.task2loss.setdefault(name, RunningMeter(f"loss/{name}"))(value)

    def _log(self, step, metrics):
        dt = time.time() - self.t_start
        meters = [m for m in self.task2loss.values() if m.val is not None]
        TB_LOGGER.log_scalar_dict({m.name: m.val for m in meters}, step=step)
        if self.lr_schedule is not None:
            TB_LOGGER.add_scalar("lr", float(self.lr_schedule(step)), step)
        # reference logs grad_norm every window (pretrain.py:330-332)
        TB_LOGGER.add_scalar("grad_norm", float(metrics["grad_norm"]), step)
        # the global batch's counts (a host gather over ranks)
        kinds = ("ex", "in", "loss")
        got = summed({(kind, t): c[i] for t, c in self.counts.items()
                      for i, kind in enumerate(kinds)})
        tot_ex = sum(got["ex", t] for t in self.counts)
        TB_LOGGER.add_scalar("perf/ex_per_s", tot_ex / dt, step)
        for t in self.counts:
            for kind in kinds:
                TB_LOGGER.add_scalar(f"perf/{t}_{kind}_per_s",
                                     got[kind, t] / dt, step)
        LOGGER.info("step %d/%d (%.0f ex/s) %s", step, self.num_train_steps,
                    tot_ex / dt, {m.name: round(m.val, 4) for m in meters})

    def _log_valid(self, step, logs):
        LOGGER.info("step %d validation: %s", step, logs)
