"""What the training cells share: the window around the port's own loop,
the set-up captures, the end-to-end metrics, and the comparison with the
reference's first steps.

The set-up builds one train state and hands it to the loop's ``run()``.
The loop's first steps (the mix's ``check.steps``) run on the first
batches of the feed. In the first step of each task the gradient the
optimizer gets is read, leaf by leaf, as its ``step()`` is called; after
the last checked step, the parameters. One batch of every bucket
shape follows (the warm-up), then ``WARM_STEPS`` more steps, and the
window opens. The reference later repeats the checked steps on its own
rebuild of the same rows from the same initial weights and dropout seeds.
"""

from __future__ import annotations

import gc
import statistics
from typing import Callable, Dict, List, Optional

import torch

from gpubench.harness import (leaf_gap, leaf_gaps, make_params,
                              percentile)
from gpubench.tracing import SubWindowProfiler, WindowControl

WARM_STEPS = 4
# leaves whose reference gradient is below this share of the median leaf's
# move by round-off alone and are left out of the change
STILL_LEAF = 1e-3


class Captures:
    """The program's numbers for the check, read in set-up: each step's
    loss, each task's first gradient (by task, ``None`` for a one-task
    cell) and the change after the checked steps."""

    def __init__(self):
        self.losses: List[torch.Tensor] = []
        self.grad: Dict[Optional[str], Dict[str, float]] = {}
        self.change: Dict[str, float] = {}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.detach().float().norm()) for n, t in tensors.items()}


def setup_hooks(state, caps: Captures, initial: Callable, check_steps: int,
                task_of: Callable[[int], Optional[str]], tasks):
    """Watch the set-up steps: in the first step of each of ``tasks``
    (``task_of(step)``) the gradient the optimizer gets, by leaf, as its
    ``step()`` is called (before its clip); after step ``check_steps`` the
    parameters' change from ``initial()``. Returns the loop's callback."""
    inner = state.opt.step
    params = dict(state.model.named_parameters())
    done = [0]

    def step():
        done[0] += 1
        task = task_of(done[0])
        if task not in caps.grad:
            caps.grad[task] = leaf_norms(
                {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()})
        return inner()

    state.opt.step = step

    def on_step(step: int):
        if step != check_steps:
            return
        state.opt.step = inner
        missing = set(tasks) - set(caps.grad)
        if missing:
            raise ValueError(f"the first {check_steps} steps hold no "
                             f"batch of {sorted(missing)}")
        p0 = initial()
        caps.change = {n: float((p.detach() - p0[n]).norm())
                       for n, p in params.items()}
        del p0
    return on_step


def make_window(ctx, n_warm: int, caps: Captures, state, initial: Callable,
                check_steps: int,
                task_of: Callable[[int], Optional[str]] = lambda s: None,
                tasks=(None,), profile_want=None, profile_steps=6):
    profiler = None
    if ctx.trace:
        profiler = SubWindowProfiler(ctx.device, ctx.seconds,
                                     ctx.dirs["trace"], profile_steps,
                                     want=profile_want)
        profiler.warm()

    control = WindowControl(
        ctx.device, ctx.seconds, check_steps + n_warm + WARM_STEPS,
        on_step=setup_hooks(state, caps, initial, check_steps, task_of,
                            tasks),
        profiler=profiler)
    return control, profiler


def end_to_end(ctx, control: WindowControl, tap) -> Dict[str, float]:
    steps = list(control.window_steps)
    wall = control.t1 - control.t0
    ex = sum(tap.items[s - 1]["ex"] for s in steps)
    out = {"train_ex_per_s": ex / wall,
           "train_step_ms_p95": percentile(control.step_ms(), 95),
           "setup_s": control.t0 - ctx.t_start}
    if torch.device(ctx.device).type == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


class Record:
    """What the per-layer readers read: the work of the window's batches
    and of the profiled ones, the window, the feed and the trace."""

    def __init__(self, control: WindowControl, tap, profiler=None):
        from gpubench.tracing import reduce_trace

        self.window_s = control.t1 - control.t0
        self.steps = list(control.window_steps)
        self.work = [tap.items[s - 1] for s in self.steps]
        self.prof_work, self.profile = [], None
        if profiler is not None and profiler.done:
            self.profile = reduce_trace(profiler.out, profiler.wall_s,
                                        len(profiler.steps))
            self.prof_work = [tap.items[s - 1] for s in profiler.steps]


def free():
    """Return what the dropped objects held to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_steps(model, fwd_loss: Callable, batches: List[tuple],
                    run_seed: int, opt) -> Dict:
    """The reference's checked steps on ``batches`` ((task, batch) pairs,
    ``fwd_loss(task, batch, seeds)``): losses, the gradient (before the
    clip) of each task's first step, and the change's norms by leaf."""
    from gpubench.reference.philox import StepSeeds

    params = dict(model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in params.items()}
    out = {"losses": [], "grad": {}}
    for s, (task, batch) in enumerate(batches):
        loss = fwd_loss(task, batch, StepSeeds(run_seed, s))
        loss.backward()
        given = opt.step()
        out["losses"].append(float(loss.detach()))
        if task not in out["grad"]:
            out["grad"][task] = leaf_norms(given)
        del loss, given
    out["change"] = {n: float((p.detach() - p0[n]).norm())
                     for n, p in params.items()}
    return out


def _suffix(task: Optional[str]) -> str:
    return "" if task is None else "." + task


def compare(prog: Dict, ref: Dict, diagnostics: bool = False
            ) -> Dict[str, float]:
    """The numbers compared: by the worst leaf, the gap of norms of each
    task's first gradient (``grad_gap``, ``grad_gap.<task>``) and of the
    change (``change_gap``) over the leaves that some checked gradient of
    the reference moves. With ``diagnostics``, also the worst step's loss
    gap, each gradient's median-leaf gap and the worst leaves' names."""
    out, notes, moving = {}, {}, set()
    for task, ref_g in ref["grad"].items():
        key = _suffix(task)
        gaps = leaf_gaps(prog["grad"][task], ref_g)
        at = max(gaps, key=gaps.get)
        out["grad_gap" + key] = gaps[at]
        med = sorted(ref_g.values())[len(ref_g) // 2]
        moving |= {n for n, g in ref_g.items() if g >= STILL_LEAF * med}
        if diagnostics:
            notes["grad_median_gap" + key] = statistics.median(gaps.values())
            notes["grad_leaf" + key] = at
    out["change_gap"], change_at = leaf_gap(prog["change"], ref["change"],
                                            sorted(moving))
    if diagnostics:
        notes["change_leaf"] = change_at
        notes["loss_gap"] = max(abs(p - r) / max(abs(r), 1e-30)
                                for p, r in zip(prog["losses"],
                                                ref["losses"]))
        out.update(notes)
    return out


def program_numbers(caps: Captures) -> Dict:
    return {"losses": [float(x) for x in caps.losses],
            "grad": caps.grad, "change": caps.change}


def plant_stale(state):
    """The fault ``stale``: an optimizer step that leaves the state as it
    was (it only clears the gradients)."""
    def unchanged():
        for p in state.model.parameters():
            p.grad = None
    state.opt.step = unchanged


def initial_params(shapes, kinds, seed, device, std):
    return lambda: make_params(shapes, kinds, seed, device, std)


def count_mismatch(got: Dict, want: Dict, keys) -> int:
    """Elements of the program's batch ``got`` that differ from the
    reference's rebuild ``want`` (a whole array where the shapes differ)."""
    import numpy as np

    n = 0
    for k in keys:
        a = np.asarray(got[k], np.float64)
        b = np.asarray(want[k], np.float64)
        n += int((a != b).sum()) if a.shape == b.shape else int(b.size)
    return n
