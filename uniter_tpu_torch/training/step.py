"""The train step (counterpart of ``uniter_tpu/training/step.py``).

forward -> per-example loss -> reduction -> backward -> [accumulation] ->
[gradient sum over the ranks] -> grad-norm clip -> AdamW -> schedule,
eagerly, one device a process.

  * The batch is split over the data axis (``parallel/collectives.py``
    ``data_size``/``data_index``: every process without a model axis);
    the model ranks of a data group run the same block, each on its
    tensor-parallel blocks of the weights (``parallel/tp.py``).
  * ``loss_scale="sum"`` multiplies each rank's loss by the data size dp,
    the reference's sum of per-rank mean-loss gradients
    (utils/distributed.py:16-43; JAX ``make_train_step``'s ``dp``), and
    ``"mean"`` leaves it. Each rank's loss is its share of the global
    batch's: its numerator over the global denominator
    (``parallel.collectives.global_sum``, over the data group), so the
    optimizer's gradient sum over the data group is the one-process
    gradient of the whole batch, times dp under "sum". The reported
    ``loss`` and metrics are the sums of the data ranks' shares: the
    global values, the same on every rank (one all-reduce a step).
  * Gradient accumulation sums the micro-batch gradients (the reference
    calls backward() without dividing, train_nlvr2.py:159-170); the batch
    is then ``[accum, B, ...]``. With ``accum_split`` the data ranks split
    the accumulation axis instead of the rows: data rank p's micro-batches
    are ``p * accum ...`` of the ``dp * accum`` of a global step (the
    hard-negative driver, whose candidate batches cannot be cut).
  * ``steps_per_call`` k > 1 runs k full optimizer steps on a ``[k, B,
    ...]`` batch and returns the k losses stacked.
  * Dropout draws its seeds from a CPU generator seeded from (seed, step)
    at every step, the counterpart of the JAX step's ``fold_in(rng,
    state.step)`` (the micro-batches of an accumulated step draw from it
    in turn); with ``accum_split`` each micro-batch has its own, seeded
    from (seed, step, micro-batch), as JAX's ``split(rng, accum)`` gives
    each its key, so a rank draws its micro-batches' streams without the
    others'. A resumed run replays the masks of the run it continues. No
    rank enters the seed: every rank draws the one process's stream, and
    the generator (``ops.dropout.StepGenerator``) tells the model which
    block of the global batch's rows the rank holds (its data index), so
    each mask is drawn at that block's row base (and an attention mask at
    the rank's heads, ``parallel/tp.py``). A rank's masks are its rows of
    the one process's, and a run is the same run at any grid, as a JAX
    run is at any mesh.
Parameters and moments are fp32 (moments optionally bf16 storage); compute
runs in the model config's dtype. No loss scaling: bf16 needs none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from uniter_tpu_torch.ops.dropout import StepGenerator
from uniter_tpu_torch.parallel.fsdp import saving
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


def step_generator(seed: int, step: int, micro: Optional[int] = None, *,
                   block: int = 0, blocks: int = 1) -> StepGenerator:
    """The dropout generator of one optimizer step: a function of the run's
    seed and the step alone or, with ``micro``, of micro-batch ``micro`` of
    an accumulated step. Every rank draws this stream; ``block`` of
    ``blocks`` is the rank's block of the global batch's rows, which sets
    the row base of each mask (``ops.dropout``). (The CPU generator keeps
    32 bits of its seed, so the words are hashed into 32 bits, not packed
    into 64.)"""
    words = [int(seed), int(step)] + ([int(micro)] if micro is not None
                                      else [])
    mixed = np.random.SeedSequence(words).generate_state(1)
    gen = StepGenerator()
    gen.manual_seed(int(mixed[0]))
    gen.block, gen.blocks = int(block), int(blocks)
    return gen


def make_train_step(loss_fn: Callable, *, loss_scale: str = "sum",
                    accum_steps: int = 1, steps_per_call: int = 1,
                    accum_split: bool = False):
    """Build ``step_fn(state, batch, seed) -> (state, metrics)``.

    ``loss_fn(model, batch, generator) -> (scalar mean loss, metrics
    dict)`` with dropout seeds drawn from ``generator``, as the JAX
    package's loss functions return them. The step's ``metrics`` holds
    device tensors: the loss function's own (detached; under accumulation
    their mean over the micro-batches), ``loss`` (a scalar, or [k] with
    ``steps_per_call`` k, which keeps no others) and ``grad_norm`` of the
    last step, read back by the caller when it needs them. With
    ``accum_split`` each rank holds whole micro-batches of the global
    step's accumulation (module docstring), and draws their streams."""
    from uniter_tpu_torch.parallel.collectives import (
        all_reduce_sum, data_group, data_index, data_size)

    if loss_scale not in ("sum", "mean"):
        raise ValueError(f"loss_scale {loss_scale!r}")
    if steps_per_call > 1 and accum_steps > 1:
        raise ValueError("combine accumulation inside loss batches")
    world, rank, comm = data_size(), data_index(), data_group()
    scale = world if loss_scale == "sum" else 1
    if accum_split:  # whole micro-batches: rank p's come after p's peers'
        n_micro, micro0, block, blocks = accum_steps * world, \
            rank * accum_steps, 0, 1
    else:  # every micro-batch: this rank's block of its rows
        n_micro, micro0, block, blocks = 1, 0, rank, world

    def generator(seed: int, step: int, i: int):
        """The stream of this rank's micro-batch ``i`` of ``step``."""
        return step_generator(seed, step, micro0 + i if n_micro > 1 else None,
                              block=block, blocks=blocks)

    def backward(loss):
        (loss * scale if scale != 1 else loss).backward()

    def one(state: TrainState, batch: Dict[str, Any], seed: int):
        state.model.train()
        if accum_steps == 1:
            with saving(state.model):
                loss, metrics = loss_fn(state.model, batch,
                                        generator(seed, state.step, 0))
            backward(loss)
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            loss, stack = 0.0, []
            gen = generator(seed, state.step, 0)
            for i in range(accum_steps):
                mb = {k: v[i] for k, v in batch.items()}
                if n_micro > 1 and i:
                    gen = generator(seed, state.step, i)
                with saving(state.model):
                    micro, aux = loss_fn(state.model, mb, gen)
                backward(micro)  # .grad sums the micro-grads
                loss = loss + micro.detach()
                stack.append(aux)
            loss = loss / accum_steps
            metrics = {k: torch.stack([m[k].detach().float()
                                       for m in stack]).mean(0)
                       for k in stack[0]}
        if world > 1:
            # the data ranks' shares summed: the global values, one
            # all-reduce
            keys = sorted(metrics)
            flat = all_reduce_sum(torch.stack(
                [loss.float()] + [metrics[k].float().reshape(())
                                  for k in keys]), comm)
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
