"""UNITER pretraining model: MLM / MRFR / ITM(+WRA-OT) / MRC(-kl).

Counterpart of ``uniter_tpu/models/pretrain.py`` (reference
model/pretrain.py), with its static-shape conventions:

  * Masked positions are gathered through fixed-size slot tensors from the
    collate (``mlm_pos [B, M]`` / ``mrm_pos [B, Mr]``, validity in label -1 /
    weight 0) instead of boolean gathers (reference
    ``_compute_masked_hidden``, pretrain.py:129-133).
  * The ITM OT loss needs no ``ot_scatter``: the [txt ; img] layout keeps
    the segments at fixed offsets.
  * IPOT runs in fp32 without gradient (``ops/ot.py``); ``ot_impl`` says
    through which version: "cuda" (K7, one launch per ITM step) or "xla"
    (the plain loop). The drivers resolve it from ``--device``.

Submodules are named after the reference ``.pt`` keys
(``cls.predictions.*``, ``feat_regress.*``, ``region_classifier.*``,
``itm_output.*``). The MLM decoder and the MRFR projection read
``uniter.embeddings.word_embeddings.weight`` and
``uniter.img_embeddings.img_linear.weight`` at call time (through
``parallel.fsdp.unit_param``, which gathers them under ``--fsdp``), so the
state dict has exactly the keys the weight bridge emits. Logits and losses
are fp32.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from uniter_tpu_torch.config import UniterConfig
from uniter_tpu_torch.models.common import encode_batch, txt_img_pad_masks
from uniter_tpu_torch.models.encoder import Linear, UniterModel
from uniter_tpu_torch.models.heads import (
    MLMHead, RegionClassification, RegionFeatureRegression)
from uniter_tpu_torch.models.losses import (
    cross_entropy_ignore, kl_div, weighted_mean)
from uniter_tpu_torch.parallel.collectives import global_sum
from uniter_tpu_torch.parallel.fsdp import unit_param
from uniter_tpu_torch.ops.ot import optimal_transport_dist
from uniter_tpu_torch.utils.const import IMG_DIM, IMG_LABEL_DIM


def gather_slots(seq, pos):
    """seq [B,S,H], pos [B,M] -> [B,M,H] (static-shape masked-hidden gather)."""
    idx = pos.long()[..., None].expand(-1, -1, seq.shape[-1])
    return torch.gather(seq, 1, idx)


class UniterForPretraining(nn.Module):
    def __init__(self, cfg: UniterConfig, img_dim: int = IMG_DIM,
                 img_label_dim: int = IMG_LABEL_DIM, ot_impl: str = "xla"):
        super().__init__()
        if ot_impl not in ("xla", "cuda"):
            raise ValueError(f"unknown ot_impl {ot_impl!r}")
        self.ot_impl = ot_impl
        self.uniter = UniterModel(cfg, img_dim)
        self.cls = MLMHead(cfg)
        self.feat_regress = RegionFeatureRegression(cfg, img_dim)
        self.region_classifier = RegionClassification(cfg, img_label_dim)
        self.itm_output = Linear(cfg.hidden_size, 2)

    def _encode(self, batch, deterministic, generator):
        return encode_batch(self.uniter, batch, deterministic, generator)

    # ---- MLM -------------------------------------------------------------
    def forward_mlm(self, batch, compute_loss=True, *, deterministic=False,
                    generator=None):
        seq = self._encode(batch, deterministic, generator)
        t = batch["input_ids"].shape[1]
        hidden = gather_slots(seq[:, :t], batch["mlm_pos"])  # [B, M, H]
        logits = self.cls(
            hidden, unit_param(self.uniter.embeddings.word_embeddings)).float()
        if compute_loss:
            return cross_entropy_ignore(logits, batch["mlm_tgt"], -1)
        return logits

    # ---- MRFR ------------------------------------------------------------
    def forward_mrfr(self, batch, compute_loss=True, *, deterministic=False,
                     generator=None):
        seq = self._encode(batch, deterministic, generator)
        t = batch["input_ids"].shape[1]
        hidden = gather_slots(seq[:, t:], batch["mrm_pos"])  # [B, Mr, H]
        pred = self.feat_regress(
            hidden, unit_param(self.uniter.img_embeddings.img_linear)).float()
        if compute_loss:
            tgt = batch["feat_targets"].float()
            w = batch["mrm_valid"].float()[..., None].expand_as(pred)
            return (pred - tgt).square() * w, w
        return pred

    # ---- ITM (+OT) -------------------------------------------------------
    def forward_itm(self, batch, compute_loss=True, compute_ot=True, *,
                    deterministic=False, generator=None):
        seq = self._encode(batch, deterministic, generator)
        pooled = self.uniter.pooler(seq)
        itm_scores = self.itm_output(pooled).float()
        ot_dist = None
        if compute_ot:
            t = batch["input_ids"].shape[1]
            txt_pad, img_pad = txt_img_pad_masks(batch)
            ot_dist = optimal_transport_dist(
                seq[:, :t], seq[:, t:], txt_pad, img_pad, impl=self.ot_impl)
        if compute_loss:
            loss, w = cross_entropy_ignore(itm_scores, batch["targets"], -1)
            return loss, w, ot_dist
        return itm_scores, ot_dist

    # ---- MRC(-kl) --------------------------------------------------------
    def forward_mrc(self, batch, task="mrc-kl", compute_loss=True, *,
                    deterministic=False, generator=None):
        seq = self._encode(batch, deterministic, generator)
        t = batch["input_ids"].shape[1]
        hidden = gather_slots(seq[:, t:], batch["mrm_pos"])
        logits = self.region_classifier(hidden).float()  # [B, Mr, L]
        if not compute_loss:
            return logits
        tgt = batch["label_targets"].float()  # [B, Mr, L]
        valid = batch["mrm_valid"].float()  # [B, Mr]
        if "kl" in task:
            logp = torch.log_softmax(logits, dim=-1)
            loss = kl_div(logp, tgt) * valid[..., None]
            return loss, valid[..., None].expand_as(loss)
        # hard label: argmax over non-background classes, +1; background (0)
        # excluded as target (pretrain.py:221-227)
        labels = tgt[..., 1:].argmax(-1) + 1
        labels = torch.where(valid > 0, labels, torch.full_like(labels, -1))
        return cross_entropy_ignore(logits, labels, -1)

    # ---- dispatch --------------------------------------------------------
    def forward(self, batch: Dict[str, Any], task: str = "mlm",
                compute_loss: bool = True, *, deterministic: bool = False,
                generator=None):
        kw = dict(deterministic=deterministic, generator=generator)
        if task == "mlm":
            return self.forward_mlm(batch, compute_loss, **kw)
        if task == "mrfr":
            return self.forward_mrfr(batch, compute_loss, **kw)
        if task.startswith("itm"):
            return self.forward_itm(
                batch, compute_loss,
                compute_ot=batch.get("compute_ot", True), **kw)
        if task.startswith("mrc"):
            return self.forward_mrc(batch, task, compute_loss, **kw)
        raise ValueError(f"invalid task {task}")

    def scalar_loss(self, batch, task: str, *, ot_lambda: float = 0.0,
                    deterministic: bool = False, generator=None):
        """The reference's per-step scalar loss (pretrain.py:269-296): the
        mean over valid elements; ITM adds
        lambda * (sum(ot_pos) - sum(ot_neg)) / (n_pos + n_neg). Returns
        (loss, metrics) with ``itm_xe`` and ``itm_ot``, or the task's own
        name."""
        if task.startswith("itm"):
            loss, w, ot_dist = self.forward_itm(
                batch, True, compute_ot=ot_lambda > 0.0,
                deterministic=deterministic, generator=generator)
            itm_loss = weighted_mean(loss, w)
            if ot_dist is not None:
                targets = batch["targets"]
                pos = (targets == 1).float()
                neg = (targets == 0).float()
                n = global_sum(pos.sum() + neg.sum()).clamp_min(1.0)
                ot_loss = ((ot_dist * pos).sum() - (ot_dist * neg).sum()) / n
                return itm_loss + ot_lambda * ot_loss, {
                    "itm_xe": itm_loss.detach(), "itm_ot": ot_loss.detach()}
            return itm_loss, {"itm_xe": itm_loss.detach()}
        loss, w = self(batch, task, True, deterministic=deterministic,
                       generator=generator)
        scalar = weighted_mean(loss, w)
        return scalar, {task: scalar.detach()}
