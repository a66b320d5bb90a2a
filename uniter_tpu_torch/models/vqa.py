"""VQA (and, with num_answer=3, SNLI-VE) task model.

Counterpart of ``uniter_tpu/models/vqa.py`` (reference model/vqa.py,
3129-answer head). The head is the reference's
``Sequential(Linear, GELU, LayerNorm, Linear)`` named ``vqa_output``, so
released and exported state dicts load with ``strict=True``. The BCE loss
arrives with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from uniter_tpu_torch.config import UniterConfig
from uniter_tpu_torch.models.common import encode_batch
from uniter_tpu_torch.models.encoder import LayerNorm, Linear, UniterModel
from uniter_tpu_torch.ops.activations import gelu


class GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


class UniterForVisualQuestionAnswering(nn.Module):
    """CLS -> Linear(H, 2H) + GELU + LN -> Linear(2H, num_answer)."""

    def __init__(self, cfg: UniterConfig, img_dim: int = 2048,
                 num_answer: int = 3129):
        super().__init__()
        h = cfg.hidden_size
        self.uniter = UniterModel(cfg, img_dim)
        self.vqa_output = nn.Sequential(
            Linear(h, 2 * h), GELU(), LayerNorm(2 * h, cfg.layer_norm_eps),
            Linear(2 * h, num_answer))

    def predict(self, batch, *, deterministic: bool = True) -> torch.Tensor:
        seq = encode_batch(self.uniter, batch, deterministic)
        pooled = self.uniter.pooler(seq)
        return self.vqa_output(pooled).float()

    def forward(self, batch, *, deterministic: bool = True):
        return self.predict(batch, deterministic=deterministic)
