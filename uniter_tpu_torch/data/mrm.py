"""MRM (masked region modeling) datasets: MRFR + MRC(-kl)
(reference data/mrm.py; a copy of ``uniter_tpu/data/mrm.py`` over the
port's data layer).

Region masking: each region masked with ``mask_prob``, at least one always
masked (data/mrm.py:15-21). Masked features are zero-filled in the input
(:38-41) and additionally receive mask_embedding row 1 inside the model via
``img_masks``. Targets are gathered into fixed slots (feat for MRFR, soft
labels for MRC)."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from uniter_tpu_torch.data.buckets import collate_joint, slots_from_mask
from uniter_tpu_torch.data.datasets import JointDataset


def get_img_mask(mask_prob: float, num_bb: int,
                 rng: np.random.RandomState) -> np.ndarray:
    mask = rng.random_sample(num_bb) < mask_prob
    if not mask.any():
        mask[rng.randint(num_bb)] = True
    return mask


def mrm_slots(r_bucket: int) -> int:
    return max(1, math.ceil(0.3 * r_bucket) + 1)


def _base_record(ds: JointDataset, i: int):
    ex = ds.example(i)
    input_ids = ds.txt_db.combine_inputs(ex["input_ids"])
    feat, pos7, nbb = ds.img_feat(i)
    return input_ids, feat, pos7, nbb


class MrfrDataset(JointDataset):
    def __init__(self, mask_prob: float, *args, **kw):
        super().__init__(*args, **kw)
        self.mask_prob = mask_prob

    def get_record(self, i: int, rng: np.random.RandomState) -> Dict:
        input_ids, feat, pos7, nbb = _base_record(self, i)
        img_mask = get_img_mask(self.mask_prob, nbb, rng)
        feat_target = feat.copy()
        feat = np.where(img_mask[:, None], 0.0, feat).astype(np.float32)
        return dict(input_ids=input_ids, img_feat=feat, img_pos_feat=pos7,
                    img_masks=img_mask, feat_target_full=feat_target)

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        batch = collate_joint(
            records, t_bucket, r_bucket, batch_size,
            fields={"img_masks": ("img", 0),
                    "feat_target_full": ("img", 0.0)},
        )
        n_slots = mrm_slots(r_bucket)
        pos, valid = slots_from_mask(
            batch["img_masks"].astype(bool), n_slots)
        full = batch.pop("feat_target_full")  # [B, R, D]
        batch["mrm_pos"] = pos
        batch["mrm_valid"] = valid
        batch["feat_targets"] = np.take_along_axis(
            full, pos[..., None], axis=1)
        return batch


class MrcDataset(JointDataset):
    def __init__(self, mask_prob: float, *args, **kw):
        super().__init__(*args, **kw)
        self.mask_prob = mask_prob

    def get_record(self, i: int, rng: np.random.RandomState) -> Dict:
        ex = self.example(i)
        input_ids = self.txt_db.combine_inputs(ex["input_ids"])
        dump = self.img_db.get_dump(self.img_fnames[i])
        feat = np.asarray(dump["features"], np.float32)
        bb = np.asarray(dump["norm_bb"], np.float32)
        pos7 = np.concatenate([bb, bb[:, 4:5] * bb[:, 5:6]], axis=-1)
        soft_labels = np.asarray(dump["soft_labels"], np.float32)
        nbb = feat.shape[0]
        img_mask = get_img_mask(self.mask_prob, nbb, rng)
        feat = np.where(img_mask[:, None], 0.0, feat).astype(np.float32)
        return dict(input_ids=input_ids, img_feat=feat, img_pos_feat=pos7,
                    img_masks=img_mask, soft_labels_full=soft_labels)

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        batch = collate_joint(
            records, t_bucket, r_bucket, batch_size,
            fields={"img_masks": ("img", 0),
                    "soft_labels_full": ("img", 0.0)},
        )
        n_slots = mrm_slots(r_bucket)
        pos, valid = slots_from_mask(batch["img_masks"].astype(bool), n_slots)
        full = batch.pop("soft_labels_full")
        batch["mrm_pos"] = pos
        batch["mrm_valid"] = valid
        batch["label_targets"] = np.take_along_axis(
            full, pos[..., None], axis=1)
        return batch
