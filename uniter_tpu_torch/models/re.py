"""Referring-expression comprehension: scoring region tokens.

Counterpart of ``uniter_tpu/models/re.py`` (reference model/re.py). The
static [txt; img] layout makes the reference's per-example
``_get_image_hidden`` loop (re.py:125-149) one slice ``seq[:, T:]``;
non-object positions are filled with -1e4 (re.py:68). The head is the
reference's: ``re_output`` a Linear(H, 1) at ``mlp=1``, a
``Sequential(Linear(H, H), GELU, LayerNorm, Linear(H, 1))`` at ``mlp=2``
(re.py:30-35), so the weight bridge's state dicts load with
``strict=True``.

The loss is CE over regions ("cls") or a margin ranking loss over sigmoid
scores against one negative per example ("rank", re.py:94-123). The
negatives are sampled on the device (``sample_neg``): the hard negative is
the top-scoring region other than the target, the easy one uniform over
the valid non-target regions, and bernoulli(``hard_ratio``) picks between
them. The draws come from a generator on the scores' device seeded from
the step's generator, so a resumed run replays the same negatives. Over
several processes every rank seeds that generator alike, draws the noise
of the global batch and takes its block's rows, so each rank samples the
negatives one process samples for those rows.
"""

from __future__ import annotations

import torch
from torch import nn

from uniter_tpu_torch.config import UniterConfig
from uniter_tpu_torch.models.common import encode_batch
from uniter_tpu_torch.models.encoder import LayerNorm, Linear, UniterModel
from uniter_tpu_torch.models.heads import GELU
from uniter_tpu_torch.models.losses import cross_entropy, margin_ranking
from uniter_tpu_torch.ops.dropout import batch_block

NEG_FILL = -1e4


def obj_masks_of(batch):
    """True at the region slots that hold no object (padding)."""
    masks = batch.get("obj_masks")
    if masks is None:
        t = batch["input_ids"].shape[1]
        masks = ~batch["attn_mask"][:, t:].bool()
    return masks.bool()


def sampling_generator(generator: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` whose seed is the next draw of the step's
    (CPU) ``generator``: a function of the run's seed and the step."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def sample_neg(scores, targets, obj_masks, hard_ratio: float,
               generator: torch.Generator, block: int = 0, blocks: int = 1):
    """One negative region per example [B] (int64), drawn on the scores'
    device: the hard negative (argmax over scores, the target excluded) with
    probability ``hard_ratio``, else the easy one, uniform over the regions
    that are neither the target nor padding (the argmax of uniform noise
    over them). The rows are ``block`` of ``blocks`` equal blocks of the
    global batch: the noise is drawn for all ``blocks * B`` rows and this
    block's taken."""
    b, n = scores.shape
    rows = slice(block * b, (block + 1) * b)
    is_target = torch.zeros((b, n), dtype=torch.bool, device=scores.device)
    is_target[torch.arange(b, device=scores.device), targets.long()] = True
    hard_ix = scores.masked_fill(is_target, float("-inf")).argmax(-1)
    noise = torch.rand((blocks * b, n), generator=generator,
                       device=scores.device)[rows]
    easy_ix = noise.masked_fill(is_target | obj_masks, -1.0).argmax(-1)
    use_hard = torch.rand((blocks * b,), generator=generator,
                          device=scores.device)[rows] < hard_ratio
    return torch.where(use_hard, hard_ix, easy_ix)


def rank_loss(scores, targets, neg_ix, margin: float):
    """Per-example margin ranking loss over sigmoid scores:
    clamp(margin + sigmoid(s_neg) - sigmoid(s_pos), 0)."""
    pos = torch.sigmoid(scores.gather(1, targets.long()[:, None])[:, 0])
    neg = torch.sigmoid(scores.gather(1, neg_ix.long()[:, None])[:, 0])
    return margin_ranking(pos, neg, margin)


class UniterForReferringExpressionComprehension(nn.Module):
    def __init__(self, cfg: UniterConfig, img_dim: int = 2048,
                 loss_type: str = "cls", margin: float = 0.2,
                 hard_ratio: float = 0.3, mlp: int = 1):
        super().__init__()
        if loss_type not in ("cls", "rank"):
            raise ValueError(f"unknown loss_type {loss_type!r}")
        h = cfg.hidden_size
        self.loss_type = loss_type
        self.margin = margin
        self.hard_ratio = hard_ratio
        # the region scores read no pooled vector: the JAX model has no
        # pooler parameters
        self.uniter = UniterModel(cfg, img_dim, pooler=False)
        if mlp == 1:
            self.re_output = Linear(h, 1)
        elif mlp == 2:
            self.re_output = nn.Sequential(
                Linear(h, h), GELU(),
                LayerNorm(h, cfg.layer_norm_eps, cfg.layer_norm_impl),
                Linear(h, 1))
        else:
            raise ValueError("MLP restricted to 1 or 2 layers")

    def predict(self, batch, *, deterministic: bool = True, generator=None):
        """Region scores [B, R] (fp32), non-objects filled with -1e4."""
        seq = encode_batch(self.uniter, batch, deterministic, generator)
        t = batch["input_ids"].shape[1]
        scores = self.re_output(seq[:, t:])[..., 0].float()
        return scores.masked_fill(obj_masks_of(batch), NEG_FILL)

    def forward(self, batch, compute_loss: bool = True, *,
                deterministic: bool = True, generator=None):
        scores = self.predict(batch, deterministic=deterministic,
                              generator=generator)
        if not compute_loss:
            return scores
        targets = batch["targets"]
        if targets.dim() > 1:
            targets = targets[..., 0]
        if self.loss_type == "cls":
            return cross_entropy(scores, targets)
        if generator is None:
            raise ValueError("the rank loss samples its negatives from the "
                             "step's generator; pass one")
        neg_ix = sample_neg(scores.detach(), targets, obj_masks_of(batch),
                            self.hard_ratio,
                            sampling_generator(generator, scores.device),
                            *batch_block(generator))
        return rank_loss(scores, targets, neg_ix, self.margin)
