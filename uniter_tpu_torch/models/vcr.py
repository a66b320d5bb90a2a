"""VCR task model: per-candidate binary ranking.

Counterpart of ``uniter_tpu/models/vcr.py`` (reference model/vcr.py). The
trunk has 4 token-type rows and 81 special word rows past the text
vocabulary (the driver's surgeries, ``training/driver.py``
``load_trunk_checkpoint``; reference model/vcr.py:32-50). The head is the
reference's ``Sequential(Linear(H, 2H), ReLU, LayerNorm, Linear(2H, 2))``
named ``vcr_output`` (model/vcr.py:24-29). ``predict`` returns the [B, 2]
scores; ``forward`` the per-row cross-entropy against ``targets`` or, with
``compute_loss=False``, column 1 [B, 1], what inference ranks by
(model/vcr.py:72-77).
"""

from __future__ import annotations

from torch import nn

from uniter_tpu_torch.config import UniterConfig
from uniter_tpu_torch.models.common import encode_batch
from uniter_tpu_torch.models.encoder import LayerNorm, Linear, UniterModel
from uniter_tpu_torch.models.losses import cross_entropy

NUM_SPECIAL_TOKENS = 81  # reference train_vcr.py:37


class UniterForVisualCommonsenseReasoning(nn.Module):
    def __init__(self, cfg: UniterConfig, img_dim: int = 2048):
        super().__init__()
        h = cfg.hidden_size
        self.uniter = UniterModel(cfg, img_dim)
        self.vcr_output = nn.Sequential(
            Linear(h, 2 * h), nn.ReLU(),
            LayerNorm(2 * h, cfg.layer_norm_eps, cfg.layer_norm_impl),
            Linear(2 * h, 2))

    def predict(self, batch, *, deterministic: bool = True, generator=None):
        seq = encode_batch(self.uniter, batch, deterministic, generator)
        return self.vcr_output(self.uniter.pooler(seq)).float()  # [B, 2]

    def forward(self, batch, compute_loss: bool = True, *,
                deterministic: bool = True, generator=None):
        scores = self.predict(batch, deterministic=deterministic,
                              generator=generator)
        if compute_loss:
            targets = batch["targets"]
            if targets.dim() > 1:
                targets = targets[..., 0]
            return cross_entropy(scores, targets)
        return scores[:, 1:]
