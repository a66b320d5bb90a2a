"""Dropout, as far as inference needs it.

Counterpart of ``uniter_tpu/ops/dropout.py``. Deterministic calls (and a
rate of 0) are the identity. Live dropout needs the counter-based (Philox)
masks that the training slice brings with the attention backward and the
fused residual+LayerNorm kernels; until then it raises.
"""

from __future__ import annotations

import torch


def dropout(x: torch.Tensor, rate: float, *,
            deterministic: bool = True) -> torch.Tensor:
    if deterministic or rate == 0.0:
        return x
    raise NotImplementedError(
        "live dropout arrives with the training slice of the port "
        "(Philox masks); run with deterministic=True")
