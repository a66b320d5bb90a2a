"""Image-text retrieval models: rank scoring and online hard-negative mining.

Counterpart of ``uniter_tpu/models/itm.py`` (reference model/itm.py).
``rank_output`` is seeded from row 1 (the match row) of the pretrained
``itm_output`` (``seed_rank_head``; reference itm.py:25-28). The hard-negative
variant scores every candidate without gradient, picks the top
``hard_size`` negatives with ``torch.topk`` and trains on [pos + hard]
(reference itm.py:58-139).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from uniter_tpu_torch.config import UniterConfig
from uniter_tpu_torch.models.common import encode_batch
from uniter_tpu_torch.models.encoder import Linear, UniterModel
from uniter_tpu_torch.models.losses import margin_ranking


class UniterForImageTextRetrieval(nn.Module):
    """CLS -> pooler -> ``rank_output`` Linear(H, 1); margin-triplet loss
    over (1 pos + negatives) groups of ``sample_size`` rows (reference
    itm.py:14-55). ``itm_output`` Linear(H, 2) holds the pretrained ITM
    head, read only to seed ``rank_output``."""

    def __init__(self, cfg: UniterConfig, img_dim: int = 2048,
                 margin: float = 0.2):
        super().__init__()
        self.uniter = UniterModel(cfg, img_dim)
        self.itm_output = Linear(cfg.hidden_size, 2)
        self.rank_output = Linear(cfg.hidden_size, 1)
        self.margin = margin

    def predict(self, batch, *, deterministic: bool = True, generator=None):
        """[B, 1] rank scores in fp32."""
        seq = encode_batch(self.uniter, batch, deterministic, generator)
        return self.rank_output(self.uniter.pooler(seq)).float()

    def rank_loss(self, scores, sample_size: int):
        """``scores`` [B, 1] in groups of ``sample_size``, the positive
        first in each (reference itm.py:45-53) -> [G, sample_size - 1]."""
        s = torch.sigmoid(scores.reshape(-1, sample_size))
        return margin_ranking(s[:, :1], s[:, 1:], self.margin)

    def forward(self, batch, compute_loss: bool = True, *,
                sample_size: int = 2, deterministic: bool = True,
                generator=None):
        scores = self.predict(batch, deterministic=deterministic,
                              generator=generator)
        if compute_loss:
            return self.rank_loss(scores, sample_size)
        return scores


class UniterForImageTextRetrievalHardNeg(UniterForImageTextRetrieval):
    """Score the candidates (the positive at row 0), mine the top
    ``hard_size`` negatives, train on [pos + hard] (reference
    itm.py:58-139). Same parameters as the base model.

    The whole batch is ONE candidate group: row 0 the positive, rows 1..N
    its negatives, no padding rows (``data.itm.hard_neg_collate`` builds
    exactly that)."""

    def __init__(self, cfg: UniterConfig, img_dim: int = 2048,
                 margin: float = 0.2, hard_size: int = 16):
        super().__init__(cfg, img_dim, margin)
        self.hard_size = hard_size

    def mine(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Row indices [1 + hard_size] of the positive and the hard
        negatives, from a scoring pass without gradient and in eval mode
        (no dropout), highest score first."""
        n_cand = batch["input_ids"].shape[0]
        if n_cand <= self.hard_size:
            raise ValueError(
                f"hard_size={self.hard_size} needs more candidate rows, got "
                f"{n_cand} (the batch must be one [pos + negatives] group)")
        was_training = self.training
        self.eval()
        with torch.no_grad():
            scores = self.predict(batch, deterministic=True)[:, 0]
        self.train(was_training)
        hard = torch.topk(scores[1:], self.hard_size).indices
        return torch.cat([hard.new_zeros(1), hard + 1])

    def forward(self, batch: Dict[str, Any], compute_loss: bool = True, *,
                sample_size: int = 2, deterministic: bool = True,
                generator=None):
        if not compute_loss:
            return self.predict(batch, deterministic=deterministic,
                                generator=generator)
        n_cand = batch["input_ids"].shape[0]
        idx = self.mine(batch)
        hard_batch = {
            k: v.index_select(0, idx.to(v.device))
            if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == n_cand
            else v
            for k, v in batch.items()}
        scores = self.predict(hard_batch, deterministic=deterministic,
                              generator=generator)
        return self.rank_loss(scores, self.hard_size + 1)


def _row1(a):
    return a[1:2].copy() if isinstance(a, np.ndarray) else a[1:2].clone()


def init_rank_output_from_itm(sd: Dict[str, Any]) -> Dict[str, Any]:
    """``rank_output`` <- row 1 of ``itm_output`` in a state dict (reference
    itm.py:25-28); tensors or numpy arrays, updated in place."""
    sd["rank_output.weight"] = _row1(sd["itm_output.weight"])
    sd["rank_output.bias"] = _row1(sd["itm_output.bias"])
    return sd


def seed_rank_head(model: UniterForImageTextRetrieval, sd):
    """``extra`` for ``training.driver.load_trunk_checkpoint``: the ITM head
    from the normalized checkpoint when it has one, then ``rank_output``
    from its match row (the JAX package's ``seed_rank_head``, shared by
    ``train_itm`` and the zero-shot ``inf_itm``)."""
    heads = {k: v.detach().clone() for k, v in model.state_dict().items()
             if k.startswith(("itm_output.", "rank_output."))}
    for k in ("itm_output.weight", "itm_output.bias"):
        if k in sd:
            heads[k] = torch.from_numpy(np.ascontiguousarray(sd[k])).float()
    model.load_state_dict(init_rank_output_from_itm(heads), strict=False)
    return model
