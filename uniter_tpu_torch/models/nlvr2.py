"""NLVR2 task models: paired, triplet, and paired with cross-attention.

Counterpart of ``uniter_tpu/models/nlvr2.py`` (reference model/nlvr2.py).
All three run a trunk whose token-type table has 3 rows (left image type 1,
right image type 2); the widening of a 2-row checkpoint is the driver's
surgery (``training/driver.py`` ``load_trunk_checkpoint``).

Paired format: an example is 2 consecutive rows (left, right) and the pair
logit reads both rows. ``forward`` returns the per-pair (per-row for the
triplet model) cross-entropy against ``targets`` or, with
``compute_loss=False``, the [N, 2] logits; ``predict`` returns the logits.
Heads compute in fp32 from the pooled fp32 vectors, as the JAX models do.
"""

from __future__ import annotations

import torch
from torch import nn

from uniter_tpu_torch.config import UniterConfig
from uniter_tpu_torch.models.common import encode_batch
from uniter_tpu_torch.models.encoder import Linear, UniterModel
from uniter_tpu_torch.models.heads import AttentionPool, CrossAttention
from uniter_tpu_torch.models.losses import cross_entropy
from uniter_tpu_torch.ops.dropout import batch_block, dropout, rows_before


class _Nlvr2(nn.Module):
    def forward(self, batch, compute_loss: bool = True, *,
                deterministic: bool = True, generator=None):
        scores = self.predict(batch, deterministic=deterministic,
                              generator=generator)
        if compute_loss:
            return cross_entropy(scores, batch["targets"])
        return scores


class UniterForNlvr2Paired(_Nlvr2):
    """CLS-pair concat -> Linear(2H, 2). Reference model/nlvr2.py:17-62."""

    def __init__(self, cfg: UniterConfig, img_dim: int = 2048):
        super().__init__()
        self.uniter = UniterModel(cfg, img_dim)
        self.nlvr2_output = Linear(2 * cfg.hidden_size, 2)

    def predict(self, batch, *, deterministic: bool = True, generator=None):
        seq = encode_batch(self.uniter, batch, deterministic, generator)
        pooled = self.uniter.pooler(seq)  # [2N, H]
        n_pair = pooled.shape[0] // 2
        return self.nlvr2_output(
            pooled.reshape(n_pair, 2 * pooled.shape[-1]).float())


class UniterForNlvr2Triplet(_Nlvr2):
    """One row holds both images; CLS -> Linear(H, 2). Reference
    model/nlvr2.py:65-107."""

    def __init__(self, cfg: UniterConfig, img_dim: int = 2048):
        super().__init__()
        self.uniter = UniterModel(cfg, img_dim)
        self.nlvr2_output = Linear(cfg.hidden_size, 2)

    def predict(self, batch, *, deterministic: bool = True, generator=None):
        seq = encode_batch(self.uniter, batch, deterministic, generator)
        return self.nlvr2_output(self.uniter.pooler(seq).float())


class UniterForNlvr2PairedAttn(_Nlvr2):
    """Paired format + bidirectional cross-attention between the two rows'
    sequences + attention pooling. Reference model/nlvr2.py:128-204.
    ``fc`` is the reference's ``Sequential(Linear(2H, H), ReLU,
    Dropout)``; its dropout draws from the step's generator."""

    def __init__(self, cfg: UniterConfig, img_dim: int = 2048):
        super().__init__()
        h = cfg.hidden_size
        self.config = cfg
        self.uniter = UniterModel(cfg, img_dim, pooler=False)
        self.attn1 = CrossAttention(cfg)
        self.attn2 = CrossAttention(cfg)
        self.fc = nn.Sequential(Linear(2 * h, h), nn.ReLU())
        self.attn_pool = AttentionPool(h, cfg.attention_probs_dropout_prob)
        self.nlvr2_output = Linear(2 * h, 2)

    def _fc(self, x, deterministic, generator):
        y = self.fc(x)
        return dropout(y, self.config.hidden_dropout_prob,
                       deterministic=deterministic, generator=generator,
                       row_base=rows_before(batch_block(generator)[0],
                                            y.shape))

    def predict(self, batch, *, deterministic: bool = True, generator=None):
        kw = dict(deterministic=deterministic, generator=generator)
        seq = encode_batch(self.uniter, batch, deterministic, generator)
        bs, tl, d = seq.shape
        paired = seq.reshape(bs // 2, 2 * tl, d)
        left, right = paired[:, :tl], paired[:, tl:]
        pad = (batch["attn_mask"] == 0).reshape(bs // 2, 2 * tl)
        left_pad, right_pad = pad[:, :tl], pad[:, tl:]
        l2r = self.attn1(left, right, right, key_padding_mask=right_pad, **kw)
        r2l = self.attn2(right, left, left, key_padding_mask=left_pad, **kw)
        left_out = self._fc(torch.cat([l2r, left], -1), deterministic,
                            generator)
        right_out = self._fc(torch.cat([r2l, right], -1), deterministic,
                             generator)
        left_pooled = self.attn_pool(left_out, left_pad, **kw)
        right_pooled = self.attn_pool(right_out, right_pad, **kw)
        return self.nlvr2_output(
            torch.cat([left_pooled, right_pooled], -1).float())


MODEL_REGISTRY = {
    "paired": UniterForNlvr2Paired,
    "triplet": UniterForNlvr2Triplet,
    "paired-attn": UniterForNlvr2PairedAttn,
}
