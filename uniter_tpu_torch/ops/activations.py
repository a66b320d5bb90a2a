"""Activation functions.

The reference pins the *erf* form of GELU (model/layer.py:31-37), not the
tanh approximation; it matters for logit parity with released checkpoints.
Counterpart of ``uniter_tpu/ops/activations.py``.
"""

import math

import torch


def gelu(x: torch.Tensor) -> torch.Tensor:
    """erf-form GELU: x * 0.5 * (1 + erf(x / sqrt(2)))."""
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACT2FN = {"gelu": gelu, "relu": torch.relu, "swish": swish}
