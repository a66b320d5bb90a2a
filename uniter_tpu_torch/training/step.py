"""The train step (counterpart of ``uniter_tpu/training/step.py``).

forward -> per-example loss -> reduction -> backward -> [accumulation] ->
[gradient sum over the ranks] -> grad-norm clip -> AdamW -> schedule,
eagerly, one device a process.

  * ``loss_scale="sum"`` multiplies each rank's loss by the number of
    processes, the reference's sum of per-rank mean-loss gradients
    (utils/distributed.py:16-43), and ``"mean"`` leaves it. Each rank's
    loss is its share of the global batch's: its numerator over the global
    denominator (``parallel.collectives.global_sum``), so the optimizer's
    gradient sum over the ranks is the one-process gradient of the whole
    batch, times the world size under "sum" (JAX ``make_train_step``).
    The reported ``loss`` and metrics are the sums of the ranks' shares:
    the global values, the same on every rank (one all-reduce a step).
  * Gradient accumulation sums the micro-batch gradients (the reference
    calls backward() without dividing, train_nlvr2.py:159-170); the batch
    is then ``[accum, B, ...]``.
  * ``steps_per_call`` k > 1 runs k full optimizer steps on a ``[k, B,
    ...]`` batch and returns the k losses stacked.
  * Dropout draws its seeds from a CPU ``torch.Generator`` seeded from
    (seed, step, rank) at every step, the counterpart of the JAX step's
    ``fold_in(rng, state.step)``: a resumed run replays the masks of the
    run it continues, and no two ranks draw the same masks.
Parameters and moments are fp32 (moments optionally bf16 storage); compute
runs in the model config's dtype. No loss scaling: bf16 needs none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch import nn

from uniter_tpu_torch.training.optim import FusedAdamW


@dataclasses.dataclass
class TrainState:
    """The step count, the model (parameters) and the optimizer (moments,
    update count and the last step's pre-clip gradient norm)."""

    step: int
    model: nn.Module
    opt: FusedAdamW

    @property
    def gnorm(self) -> torch.Tensor:
        return self.opt.gnorm


def step_generator(seed: int, step: int, rank: int = 0) -> torch.Generator:
    """The dropout generator of one optimizer step on one rank: a function
    of the run's seed, the step and the rank alone. Rank 0 draws what a
    single process draws; every other rank hashes its index in too, so two
    ranks never apply the same masks or draws to different rows. (The CPU
    generator keeps 32 bits of its seed, so the words are hashed into 32
    bits, not packed into 64.)"""
    words = [int(seed), int(step)] + ([int(rank)] if rank else [])
    mixed = np.random.SeedSequence(words).generate_state(1)
    return torch.Generator().manual_seed(int(mixed[0]))


def make_train_step(loss_fn: Callable, *, loss_scale: str = "sum",
                    accum_steps: int = 1, steps_per_call: int = 1):
    """Build ``step_fn(state, batch, seed) -> (state, metrics)``.

    ``loss_fn(model, batch, generator) -> (scalar mean loss, metrics
    dict)`` with dropout seeds drawn from ``generator``, as the JAX
    package's loss functions return them. The step's ``metrics`` holds
    device tensors: the loss function's own (detached; under accumulation
    their mean over the micro-batches), ``loss`` (a scalar, or [k] with
    ``steps_per_call`` k, which keeps no others) and ``grad_norm`` of the
    last step, read back by the caller when it needs them."""
    from uniter_tpu_torch.parallel.collectives import (
        all_reduce_sum, is_distributed, num_processes, process_index)

    if loss_scale not in ("sum", "mean"):
        raise ValueError(f"loss_scale {loss_scale!r}")
    if steps_per_call > 1 and accum_steps > 1:
        raise ValueError("combine accumulation inside loss batches")
    scale = num_processes() if loss_scale == "sum" else 1
    rank = process_index()

    def backward(loss):
        (loss * scale if scale != 1 else loss).backward()

    def one(state: TrainState, batch: Dict[str, Any], seed: int):
        gen = step_generator(seed, state.step, rank)
        state.model.train()
        if accum_steps == 1:
            loss, metrics = loss_fn(state.model, batch, gen)
            backward(loss)
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            loss, stack = 0.0, []
            for i in range(accum_steps):
                mb = {k: v[i] for k, v in batch.items()}
                micro, aux = loss_fn(state.model, mb, gen)
                backward(micro)  # .grad sums the micro-grads
                loss = loss + micro.detach()
                stack.append(aux)
            loss = loss / accum_steps
            metrics = {k: torch.stack([m[k].detach().float()
                                       for m in stack]).mean(0)
                       for k in stack[0]}
        if is_distributed():
            # the ranks' shares summed: the global values, one all-reduce
            keys = sorted(metrics)
            flat = all_reduce_sum(torch.stack(
                [loss.float()] + [metrics[k].float().reshape(())
                                  for k in keys]))
            loss = flat[0].to(loss.dtype)
            metrics = {k: flat[j + 1] for j, k in enumerate(keys)}
        state.opt.step()
        state.step += 1
        return loss, metrics

    def step_fn(state: TrainState, batch: Dict[str, Any], seed: int):
        if steps_per_call > 1:
            losses = [one(state, {k: v[j] for k, v in batch.items()}, seed)[0]
                      for j in range(steps_per_call)]
            loss, metrics = torch.stack(losses), {}
        else:
            loss, metrics = one(state, batch, seed)
        return state, {**metrics, "loss": loss, "grad_norm": state.gnorm}

    return step_fn
