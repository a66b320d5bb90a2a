"""What the harness records around the program, from its own files: the
feed it hands the loop, the window's step clock and the profiled
sub-window, and the reduction of that sub-window's trace.

* ``FeedTap`` wraps the loader the loop reads: the host clock around each
  ``next()`` of the loader (on the loop's prefetch thread), the work each
  batch needs (``yardstick``), host references to the first batches (for
  the check), and one batch of every bucket shape injected after them
  (the warm-up).
* ``WindowControl`` is the loop's ``preempt`` object: the loops call its
  ``poll()`` once after every optimizer step. It runs the set-up steps'
  callbacks, opens the window after the last of them (a device
  synchronise, the peak memory counter reset, the host clock, a CUDA
  event), records a CUDA event after
  every window step without synchronising, profiles a short steady
  sub-window in the middle of a traced run, and closes the window at a
  device synchronise once ``seconds`` have passed.
* ``reduce_trace`` reads the profiler's Chrome trace: device busy time as
  the union of kernel, copy and set intervals, device time by name, the
  device operations, and the longest idle gaps by the host operation under
  them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class FeedTap:
    """The loader the loop iterates. ``account(item)`` gives the work of a
    batch (a dict); ``warm`` items go in after the first ``keep`` real
    ones."""

    def __init__(self, inner, account: Callable, keep: int = 3,
                 warm: Optional[List] = None):
        self.inner = inner
        self.account = account
        self.keep = keep
        self.warm = list(warm or [])
        self.items: List[Dict] = []  # per yielded item, in loop order
        self.kept: List = []

    def __iter__(self):
        it = iter(self.inner)
        n_real = 0
        while True:
            if n_real == self.keep and self.warm:
                for w in self.warm:
                    self.items.append({**self.account(w), "feed_s": 0.0,
                                       "warm": True})
                    yield w
                self.warm = []
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            dt = time.perf_counter() - t0
            self.items.append({**self.account(item), "feed_s": dt})
            if n_real < self.keep:
                self.kept.append(item)
            n_real += 1
            yield item


class _Clock:
    """CUDA events on the card, host times elsewhere."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def intervals_ms(self, marks) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


class WindowControl:
    def __init__(self, device, seconds: float, setup_steps: int,
                 on_step: Optional[Callable[[int], None]] = None,
                 profiler=None):
        self.clock = _Clock(device)
        self.seconds = float(seconds)
        self.setup_steps = int(setup_steps)
        self.on_step = on_step
        self.profiler = profiler
        self.step = 0
        self.t0 = self.t1 = None
        self.marks = []
        self.last = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def poll(self) -> bool:
        self.step += 1
        if self.step <= self.setup_steps:
            if self.on_step is not None:
                self.on_step(self.step)
            if self.step == self.setup_steps:
                self.clock.sync()
                if self.clock.cuda:
                    torch.cuda.reset_peak_memory_stats()
                self.t0 = time.perf_counter()
                self.marks = [self.clock.mark()]
            return False
        self.marks.append(self.clock.mark())
        elapsed = time.perf_counter() - self.t0
        if self.profiler is not None:
            self.profiler.after_step(self.step, elapsed)
        if elapsed >= self.seconds:
            self.clock.sync()
            self.t1 = time.perf_counter()
            self.last = self.step
            if self.profiler is not None:
                self.profiler.close()
            return True
        return False

    @property
    def window_steps(self) -> range:
        """The optimizer steps of the window (1-based step numbers)."""
        return range(self.setup_steps + 1, (self.last or self.step) + 1)

    def step_ms(self) -> List[float]:
        return self.clock.intervals_ms(self.marks)


class SubWindowProfiler:
    """``torch.profiler`` over the window's steps from ``start`` (a share of
    the window's seconds) until at least ``min_steps`` steps and
    ``want(steps)`` hold, or ``stop`` of the seconds have passed; a device
    synchronise on each side."""

    def __init__(self, device, seconds: float, out_dir: str, min_steps: int,
                 want: Optional[Callable[[List[int]], bool]] = None,
                 start: float = 0.4, stop: float = 0.8):
        self.device = torch.device(device)
        self.seconds = seconds
        self.out = os.path.join(out_dir, "window_trace.json")
        self.min_steps, self.want = min_steps, want
        self.start, self.stop = start, stop
        self.prof = None
        self.steps: List[int] = []
        self.wall_s = None
        self.done = False

    def _activities(self):
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm(self):
        """One short session in set-up, so the tracer's own start-up does
        not fall into the window."""
        from torch.profiler import profile

        with profile(activities=self._activities()):
            torch.ones(8, device=self.device).sum().item()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def after_step(self, step: int, elapsed: float):
        if self.done:
            return
        if self.prof is None:
            if elapsed >= self.start * self.seconds:
                from torch.profiler import profile

                self._sync()
                self.prof = profile(activities=self._activities())
                self.prof.start()
                self._t0 = time.perf_counter()
            return
        self.steps.append(step)
        enough = len(self.steps) >= self.min_steps and (
            self.want is None or self.want(self.steps))
        if enough or elapsed >= self.stop * self.seconds:
            self.close()

    def close(self):
        if self.prof is None or self.done:
            return
        self._sync()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        os.makedirs(os.path.dirname(self.out), exist_ok=True)
        self.prof.export_chrome_trace(self.out)
        self.prof = None
        self.done = True


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(path: str, wall_s: float, n_steps: int) -> Dict:
    """Device busy seconds, device time and count by name, operations a
    step, and the ten longest idle gaps named by the innermost host
    operation at their middle."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            dev.append((span, e.get("name", "?")))
        elif e.get("cat") in HOST_CATS:
            host.append((span, e.get("name", "?")))
    by_name: Dict[str, list] = {}
    for (a, b), name in dev:
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += (b - a) * 1e-6
        rec[1] += 1
    merged = _merge([list(s) for s, _ in dev])
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = sorted(((b0 - a1, 0.5 * (a1 + b0)) for (_, a1), (b0, _)
                   in zip(merged, merged[1:])), reverse=True)[:10]
    idle = []
    for length, mid in gaps:
        under = [(s[1] - s[0], n) for s, n in host if s[0] <= mid <= s[1]]
        idle.append([min(under)[1] if under else "host outside any traced op",
                     length * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"busy_s": busy, "wall_s": wall_s, "steps": n_steps,
            "kernels": {k: tuple(v) for k, v in by_name.items()},
            "ops_per_step": len(dev) / max(n_steps, 1),
            "device_ops": [[k, v[0]] for k, v in top[:10]],
            "idle_gaps": idle}


def device_seconds(profile: Dict, *needles: str) -> float:
    """Device seconds of the kernels whose name holds any of ``needles``."""
    return sum(s for name, (s, _) in profile["kernels"].items()
               if any(k in name for k in needles))
