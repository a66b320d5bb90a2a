"""Activation functions.

The reference pins the *erf* form of GELU (model/layer.py:31-37), not the
tanh approximation; it matters for logit parity with released checkpoints.
Counterpart of ``uniter_tpu/ops/activations.py``.

``gelu`` is the composition that autograd runs (every training step).
``gelu_`` is the same function in place in one pass, the library's erf
GELU (computed in fp32 for bf16, rounded once), where the JAX package's
XLA fuses the composition into one loop: ``models/encoder.py``
``BertIntermediate`` runs it on FC1's output when no gradient is recorded.
"""

import math

import torch


def gelu(x: torch.Tensor) -> torch.Tensor:
    """erf-form GELU: x * 0.5 * (1 + erf(x / sqrt(2)))."""
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gelu_(x: torch.Tensor) -> torch.Tensor:
    """erf-form GELU of ``x`` in place, in one pass; returns ``x``. Only
    where nothing else holds ``x`` and no gradient is recorded."""
    return torch.ops.aten.gelu_(x)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACT2FN = {"gelu": gelu, "relu": torch.relu, "swish": swish}
