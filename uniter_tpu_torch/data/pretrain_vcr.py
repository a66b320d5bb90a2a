"""VCR 2nd-stage pretraining datasets (reference data/pretrain_vcr.py; a
copy of ``uniter_tpu/data/pretrain_vcr.py`` over the port's data layer).

Text = question + gold answer (+ gold rationale for qar) with txt_type_ids
(0 question / 2 answer / 3 rationale, reference :16-62); MLM / MRFR / MRC
variants reuse the standard masking with the VCR dual-image features.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from uniter_tpu_torch.data.buckets import (
    collate_joint, slots_from_labels, slots_from_mask,
)
from uniter_tpu_torch.data.mlm import mlm_slots, random_word
from uniter_tpu_torch.data.mrm import get_img_mask, mrm_slots
from uniter_tpu_torch.data.vcr import VcrJointDataset


def _vcr_pretrain_text(ds, ex):
    """(ids-without-specials, type-ids) for q + gt answer (+ gt rationale)
    (reference pretrain_vcr.py:16-62)."""
    q = list(ex["input_ids"])
    types = [0] * len(q)
    a = list(ex["input_ids_as"][ex["qa_target"]])
    ids = q + [ds.txt_db.sep] + a
    types += [2] * (len(a) + 1)
    if ds.task == "qar" or ds.task == "qa,qar":
        r = list(ex["input_ids_rs"][ex["qar_target"]])
        ids += [ds.txt_db.sep] + r
        types += [3] * (len(r) + 1)
    return ids, types


def _wrap(ds, ids, types):
    input_ids = np.asarray(
        [ds.txt_db.cls_] + ids + [ds.txt_db.sep], np.int32)
    txt_type_ids = np.asarray([0] + types + [types[-1] if types else 0],
                              np.int32)
    return input_ids, txt_type_ids


class MlmDatasetForVCR(VcrJointDataset):
    def get_record(self, i: int, rng: np.random.RandomState) -> Dict:
        ex = self.example(i)
        ids, types = _vcr_pretrain_text(self, ex)
        tokens, labels = random_word(
            ids, self.txt_db.v_range, self.txt_db.mask, rng)
        input_ids, txt_type_ids = _wrap(self, tokens, types)
        txt_labels = np.asarray([-1] + labels + [-1], np.int32)
        feat, pos7, _ = self.joint_img_feat(i)
        return dict(input_ids=input_ids, txt_type_ids=txt_type_ids,
                    img_feat=feat, img_pos_feat=pos7, txt_labels=txt_labels)

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        batch = collate_joint(
            records, t_bucket, r_bucket, batch_size,
            fields={"txt_labels": ("txt", -1),
                    "txt_type_ids": ("txt", 0)},
        )
        pos, tgt = slots_from_labels(
            batch.pop("txt_labels"), mlm_slots(t_bucket))
        batch["mlm_pos"] = pos
        batch["mlm_tgt"] = tgt
        return batch


class MrfrDatasetForVCR(VcrJointDataset):
    def __init__(self, mask_prob, *args, **kw):
        super().__init__(*args, **kw)
        self.mask_prob = mask_prob

    def get_record(self, i: int, rng: np.random.RandomState) -> Dict:
        ex = self.example(i)
        ids, types = _vcr_pretrain_text(self, ex)
        input_ids, txt_type_ids = _wrap(self, ids, types)
        feat, pos7, nbb = self.joint_img_feat(i)
        img_mask = get_img_mask(self.mask_prob, nbb, rng)
        feat_target = feat.copy()
        feat = np.where(img_mask[:, None], 0.0, feat).astype(np.float32)
        return dict(input_ids=input_ids, txt_type_ids=txt_type_ids,
                    img_feat=feat, img_pos_feat=pos7, img_masks=img_mask,
                    feat_target_full=feat_target)

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        batch = collate_joint(
            records, t_bucket, r_bucket, batch_size,
            fields={"img_masks": ("img", 0),
                    "feat_target_full": ("img", 0.0),
                    "txt_type_ids": ("txt", 0)},
        )
        pos, valid = slots_from_mask(
            batch["img_masks"].astype(bool), mrm_slots(r_bucket))
        full = batch.pop("feat_target_full")
        batch["mrm_pos"] = pos
        batch["mrm_valid"] = valid
        batch["feat_targets"] = np.take_along_axis(full, pos[..., None],
                                                   axis=1)
        return batch


class MrcDatasetForVCR(VcrJointDataset):
    def __init__(self, mask_prob, *args, **kw):
        super().__init__(*args, **kw)
        self.mask_prob = mask_prob

    def joint_img_dump(self, i):
        pair = self.img_fnames[i]
        feats, poss, sls = [], [], []
        for db, fname in ((self.img_db_gt, pair[0]), (self.img_db, pair[1])):
            if db is None:
                continue
            d = db.get_dump(fname)
            feats.append(np.asarray(d["features"], np.float32))
            bb = np.asarray(d["norm_bb"], np.float32)
            poss.append(np.concatenate([bb, bb[:, 4:5] * bb[:, 5:6]], -1))
            sls.append(np.asarray(d["soft_labels"], np.float32))
        return (np.concatenate(feats, 0), np.concatenate(poss, 0),
                np.concatenate(sls, 0))

    def get_record(self, i: int, rng: np.random.RandomState) -> Dict:
        ex = self.example(i)
        ids, types = _vcr_pretrain_text(self, ex)
        input_ids, txt_type_ids = _wrap(self, ids, types)
        feat, pos7, soft_labels = self.joint_img_dump(i)
        nbb = feat.shape[0]
        img_mask = get_img_mask(self.mask_prob, nbb, rng)
        feat = np.where(img_mask[:, None], 0.0, feat).astype(np.float32)
        return dict(input_ids=input_ids, txt_type_ids=txt_type_ids,
                    img_feat=feat, img_pos_feat=pos7, img_masks=img_mask,
                    soft_labels_full=soft_labels)

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        batch = collate_joint(
            records, t_bucket, r_bucket, batch_size,
            fields={"img_masks": ("img", 0),
                    "soft_labels_full": ("img", 0.0),
                    "txt_type_ids": ("txt", 0)},
        )
        pos, valid = slots_from_mask(
            batch["img_masks"].astype(bool), mrm_slots(r_bucket))
        full = batch.pop("soft_labels_full")
        batch["mrm_pos"] = pos
        batch["mrm_valid"] = valid
        batch["label_targets"] = np.take_along_axis(full, pos[..., None],
                                                    axis=1)
        return batch
