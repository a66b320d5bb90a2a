"""LayerNorm with fp32 statistics (replaces apex ``FusedLayerNorm(eps=1e-12)``,
reference model/model.py:229).

Counterpart of ``_layer_norm_xla`` in ``uniter_tpu/ops/layer_norm.py``:
statistics in fp32 whatever the input dtype, the result cast back to it.
This is the plain LayerNorm of inference and of ``block_fusion="none"``;
the training tails fuse it with dropout and the residual in
``ops/fused_block.py`` (K3-K6). The JAX package's standalone Pallas
LayerNorm kernel (K8, off by default) is not ported yet.
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)
