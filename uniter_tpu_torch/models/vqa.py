"""VQA (and, with num_answer=3, SNLI-VE) task model.

Counterpart of ``uniter_tpu/models/vqa.py`` (reference model/vqa.py,
3129-answer head). The head is the reference's
``Sequential(Linear, GELU, LayerNorm, Linear)`` named ``vqa_output``, so
released and exported state dicts load with ``strict=True``. ``forward``
returns the elementwise [B, num_answer] BCE against the soft targets (the
driver reduces it) or, with ``compute_loss=False``, the logits.
"""

from __future__ import annotations

import torch
from torch import nn

from uniter_tpu_torch.config import UniterConfig
from uniter_tpu_torch.models.common import encode_batch
from uniter_tpu_torch.models.encoder import LayerNorm, Linear, UniterModel
from uniter_tpu_torch.models.heads import GELU
from uniter_tpu_torch.models.losses import binary_cross_entropy_with_logits


class UniterForVisualQuestionAnswering(nn.Module):
    """CLS -> Linear(H, 2H) + GELU + LN -> Linear(2H, num_answer)."""

    def __init__(self, cfg: UniterConfig, img_dim: int = 2048,
                 num_answer: int = 3129):
        super().__init__()
        h = cfg.hidden_size
        self.uniter = UniterModel(cfg, img_dim)
        self.vqa_output = nn.Sequential(
            Linear(h, 2 * h), GELU(),
            LayerNorm(2 * h, cfg.layer_norm_eps, cfg.layer_norm_impl),
            Linear(2 * h, num_answer))

    def predict(self, batch, *, deterministic: bool = True,
                generator=None) -> torch.Tensor:
        seq = encode_batch(self.uniter, batch, deterministic, generator)
        pooled = self.uniter.pooler(seq)
        return self.vqa_output(pooled).float()

    def forward(self, batch, compute_loss: bool = True, *,
                deterministic: bool = True, generator=None):
        scores = self.predict(batch, deterministic=deterministic,
                              generator=generator)
        if compute_loss:
            # [B, num_answer] elementwise; the driver reduces
            # mean() * num_answer (reference train_vqa.py:188)
            return binary_cross_entropy_with_logits(scores, batch["targets"])
        return scores
