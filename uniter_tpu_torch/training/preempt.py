"""Graceful preemption (counterpart of ``uniter_tpu/training/preempt.py``,
single process).

``PreemptionGuard`` installs a SIGTERM handler around the training loop.
The handler only sets a flag; the loop polls it at step boundaries and,
when it is set, flushes metrics, saves the full train state and returns,
so rerunning the same command resumes. The JAX package's cross-host
agreement on the stop step waits for the multi-GPU slice: one process
stops on the first poll after its signal.
"""

from __future__ import annotations

import signal
import threading

from uniter_tpu_torch.utils.logger import LOGGER


class PreemptionGuard:
    """Poll-based SIGTERM latch; a context manager around the hot loop."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = signals
        self._seen = False
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
        """True once the run should stop."""
        return self._seen
