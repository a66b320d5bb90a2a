"""Logging and metrics (counterpart of ``uniter_tpu/utils/logger.py``,
reference utils/logger.py).

The module-level ``LOGGER``; a ``TB_LOGGER`` singleton with the reference's
scalar names (``loss``, ``lr``, ``grad_norm``, ``perf/*``, ``valid/*``)
writing the ``scalars.jsonl`` sidecar only (one JSON object per scalar and
step; no TensorBoard event files); ``RunningMeter`` EMA(0.99) loss meters.
"""

from __future__ import annotations

import json
import logging
import math
import os
from typing import Dict, Optional

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"
logging.basicConfig(format=_LOG_FMT, datefmt=_DATE_FMT, level=logging.INFO)
LOGGER = logging.getLogger("__main__")


def add_log_to_file(log_path: str):
    fh = logging.FileHandler(log_path)
    fh.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
    logging.getLogger().addHandler(fh)


class TensorboardLogger:
    def __init__(self):
        self._jsonl = None

    def create(self, path: str):
        os.makedirs(path, exist_ok=True)
        if self._jsonl is not None:
            self._jsonl.close()
        self._jsonl = open(os.path.join(path, "scalars.jsonl"), "a")

    def add_scalar(self, name: str, value, step: int):
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps({"step": step, name: float(value)})
                          + "\n")
        self._jsonl.flush()

    def log_scalar_dict(self, log: Dict[str, float], step: int,
                        prefix: str = ""):
        if prefix:
            prefix = f"{prefix}_"
        for name, value in log.items():
            if isinstance(value, dict):
                self.log_scalar_dict(value, step, f"{prefix}{name}")
            else:
                self.add_scalar(f"{prefix}{name}", value, step)


TB_LOGGER = TensorboardLogger()


class RunningMeter:
    """Exponential-moving-average loss meter (reference utils/logger.py:68-94)."""

    def __init__(self, name: str, val: Optional[float] = None,
                 smooth: float = 0.99):
        self._name = name
        self._sm = smooth
        self._val = val

    def __call__(self, value: float):
        value = float(value)
        if math.isnan(value) or math.isinf(value):
            return
        self._val = (value if self._val is None
                     else value * (1 - self._sm) + self._val * self._sm)

    def __str__(self):
        return f"{self._name}: {self._val:.4f}"

    @property
    def val(self):
        return self._val

    @property
    def name(self):
        return self._name
