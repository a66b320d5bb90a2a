"""Per-example loss primitives shared by all task models (counterpart of
``uniter_tpu/models/losses.py``).

Models return *unreduced* losses; reduction and scaling live in the driver
and the train step, as in the reference, where VQA scales
``mean() * num_answers`` (train_vqa.py:188) and RE sums (train_re.py:195).
Every function computes in fp32.
"""

import torch
import torch.nn.functional as F

from uniter_tpu_torch.parallel.collectives import global_sum


def cross_entropy(logits, labels):
    """Per-example CE. logits [..., C]; labels int [...]."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def cross_entropy_ignore(logits, labels, ignore_index=-1):
    """CE with an ignore label; returns (loss, weight) with weight 0 at
    ignored positions (torch ``F.cross_entropy(ignore_index=...)`` with the
    weights kept for the caller's reduction)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    w = valid.float()
    return cross_entropy(logits, safe) * w, w


def binary_cross_entropy_with_logits(logits, targets):
    """Elementwise BCE-with-logits (VQA soft scores, model/vqa.py:46-50),
    the JAX package's formula: max(x, 0) - x t + log1p(exp(-|x|))."""
    x = logits.float()
    t = targets.float()
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def kl_div(log_pred, target, eps=1e-12):
    """Elementwise KL(target || pred): target * (log target - log_pred),
    zero where target == 0 (torch ``F.kl_div`` semantics,
    model/pretrain.py:217-220)."""
    t = target.float()
    return torch.where(t > 0, t * (torch.log(t.clamp_min(eps)) - log_pred),
                       torch.zeros((), device=t.device))


def weighted_mean(loss, weight):
    """sum(loss * w) / max(sum(w), 1) — ``loss.mean()`` over the rows a
    weight selects, at a static shape; over several processes this rank's
    share of the global batch's mean: the denominator sums over the ranks
    (``global_sum``), as the JAX package's mean over its global batch.
    Training losses only: the sum is a collective every rank joins."""
    w = weight.float()
    return (loss * w).sum() / global_sum(w.sum()).clamp_min(1.0)


def margin_ranking(pos, neg, margin):
    """clamp(margin + neg - pos, 0), broadcasting pos over the negatives."""
    return (margin + neg - pos).clamp_min(0.0)
