"""Graceful preemption (counterpart of ``uniter_tpu/training/preempt.py``).

``PreemptionGuard`` installs a SIGTERM handler around the training loop.
The handler only sets a flag; the loop polls it at step boundaries and,
when it is set, flushes metrics, saves the full train state and returns,
so rerunning the same command resumes. A single process stops on the
first poll after its signal. Over several processes the ranks run in
lockstep, so the stop must be agreed: every ``SYNC_EVERY``-th poll (the
same step on every rank) gathers each rank's flag (``all_gather_list``)
and all stop if any saw the signal, so they save at one step and exit
(JAX ``preempt.py:95-110``).
"""

from __future__ import annotations

import signal
import threading

from uniter_tpu_torch.utils.logger import LOGGER


class PreemptionGuard:
    """Poll-based SIGTERM latch with agreement across ranks; a context
    manager around the hot loop."""

    #: polls between agreements over several processes (a host gather;
    #: at ~1 step/s inside a 30 s SIGTERM grace)
    SYNC_EVERY = 25

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = signals
        self._seen = False  # the signal reached this process
        self._stop = False  # agreed (or, alone, seen)
        self._polls = 0
        self._prev = {}
        self._installed = False

    def _handler(self, signum, frame):
        if not self._seen:
            LOGGER.warning(
                "received signal %d — will checkpoint and exit at the next "
                "step boundary", signum)
        self._seen = True

    def install(self) -> "PreemptionGuard":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            # signal.signal works from the main thread only; the guard then
            # never fires
            LOGGER.info("PreemptionGuard disabled: not on the main thread")
            return self
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handler)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def poll(self) -> bool:
        """True once the run should stop. Every rank polls at every step
        boundary, so the poll count is the same on all of them."""
        from uniter_tpu_torch.parallel.collectives import (
            all_gather_list, num_processes)

        self._polls += 1
        if not self._stop:
            if num_processes() == 1:
                self._stop = self._seen
            elif self._polls % self.SYNC_EVERY == 0:
                self._stop = any(all_gather_list(self._seen))
        return self._stop
