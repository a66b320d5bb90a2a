"""Referring-expression datasets (reference data/re.py; a copy of
``uniter_tpu/data/re.py`` over the port's data layer).

``ReTxtTokDb`` loads refs/annotations/categories/images JSON sidecars
(re.py:17-56); ``shuffle()`` re-orders refs per epoch (re.py:65-68).
``ReDataset`` targets the gt annotation's index among the image's gt boxes
(re.py:93-128); ``ReEvalDataset`` scores gt or detected features and
evaluates IoU>0.5 (re.py:175-238).
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from uniter_tpu_torch.data.buckets import collate_joint
from uniter_tpu_torch.data.datasets import JointDataset
from uniter_tpu_torch.data.txt_db import TxtTokDb


class ReTxtTokDb(TxtTokDb):
    def __init__(self, db_dir, max_txt_len=120, **kw):
        super().__init__(db_dir, max_txt_len, **kw)
        with open(os.path.join(db_dir, "refs.json")) as f:
            refs = json.load(f)
        self.ref_ids = [r["ref_id"] for r in refs]
        self.Refs = {r["ref_id"]: r for r in refs}
        with open(os.path.join(db_dir, "annotations.json")) as f:
            anns = json.load(f)
        self.Anns = {a["id"]: a for a in anns}
        with open(os.path.join(db_dir, "categories.json")) as f:
            cats = json.load(f)
        self.Cats = {c["id"]: c["name"] for c in cats}
        with open(os.path.join(db_dir, "images.json")) as f:
            images = json.load(f)
        self.Images = {im["id"]: im for im in images}
        self.max_txt_len = max_txt_len

    def get_sent_ids(self) -> List[str]:
        out = []
        for ref_id in self.ref_ids:
            for sent_id in self.Refs[ref_id]["sent_ids"]:
                l = self.id2len.get(str(sent_id))
                if l is not None and (self.max_txt_len == -1
                                      or l < self.max_txt_len):
                    out.append(str(sent_id))
        return out

    def shuffle(self, rng: np.random.RandomState):
        rng.shuffle(self.ref_ids)


def gt_fname(image_id) -> str:
    return f"visual_grounding_coco_gt_{int(image_id):012}.npz"


def det_fname(image_id) -> str:
    return f"visual_grounding_det_coco_{int(image_id):012}.npz"


class ReDataset(JointDataset):
    def __init__(self, txt_db: ReTxtTokDb, img_db, **kw):
        self.txt_db = txt_db
        self.img_db = img_db
        # TRAIN sharding lives in BucketLoader (shared global batch plan;
        # per-host dataset splits would dispatch mismatched SPMD programs) —
        # the train dataset always spans the full ref list. Per-process
        # splits exist only on ReEvalDataset (host-local compute + gather),
        # which sets the shard fields before this runs.
        self.shard_index = getattr(self, "shard_index", 0)
        self.shard_count = getattr(self, "shard_count", 1)
        self.refresh_ids()

    def refresh_ids(self):
        from uniter_tpu_torch.data.datasets import shard_ids

        self.ids = shard_ids(self.txt_db.get_sent_ids(),
                             self.shard_index, self.shard_count)
        self.txt_lens = [self.txt_db.id2len[i] for i in self.ids]
        self.lens = list(self.txt_lens)

    def new_epoch(self, rng: np.random.RandomState):
        """per-epoch ref shuffle (reference re.py:65-68 + train_re.py:253)."""
        self.txt_db.shuffle(rng)
        self.refresh_ids()

    def size_of(self, i):
        # sent -> image_id never changes; cache it so the O(N) sampler
        # (re)builds don't decompress every text record per epoch
        sid = self.ids[i]
        cache = getattr(self, "_sid2nbb", None)
        if cache is None:
            cache = self._sid2nbb = {}
        nbb = cache.get(sid)
        if nbb is None:
            fname = gt_fname(self.txt_db[sid]["image_id"])
            nbb = cache[sid] = self.img_db.name2nbb[fname]
        return self.txt_lens[i] + 2, nbb

    def get_record(self, i: int, rng=None):
        ex = self.txt_db[self.ids[i]]
        image_id = ex["image_id"]
        feat, pos7, num_bb = self.img_db.get_img_feat(gt_fname(image_id))
        input_ids = self.txt_db.combine_inputs(ex["input_ids"])
        img = self.txt_db.Images[image_id]
        assert len(img["ann_ids"]) == num_bb, "use visual_grounding_coco_gt"
        target = img["ann_ids"].index(ex["ann_id"])
        return dict(input_ids=input_ids, img_feat=feat, img_pos_feat=pos7,
                    target=int(target), sent_id=self.ids[i])

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        batch = collate_joint(records, t_bucket, r_bucket, batch_size)
        targets = np.zeros((batch_size,), np.int32)
        for i, r in enumerate(records):
            targets[i] = r["target"]
        batch["targets"] = targets
        # non-objects (padding regions) masked out in scoring
        batch["obj_masks"] = ~batch["attn_mask"][:, t_bucket:].astype(bool)
        batch["sent_ids"] = [r["sent_id"] for r in records]
        return batch


def compute_iou(box1, box2) -> float:
    """xywh IoU (reference re.py:226-238)."""
    inter_x1 = max(box1[0], box2[0])
    inter_y1 = max(box1[1], box2[1])
    inter_x2 = min(box1[0] + box1[2] - 1, box2[0] + box2[2] - 1)
    inter_y2 = min(box1[1] + box1[3] - 1, box2[1] + box2[3] - 1)
    if inter_x1 < inter_x2 and inter_y1 < inter_y2:
        inter = (inter_x2 - inter_x1 + 1) * (inter_y2 - inter_y1 + 1)
    else:
        inter = 0
    union = box1[2] * box1[3] + box2[2] * box2[3] - inter
    return float(inter) / union


class ReEvalDataset(ReDataset):
    def __init__(self, txt_db, img_db, use_gt_feat=True, shard_index=0,
                 shard_count=1, **kw):
        self.use_gt_feat = use_gt_feat
        # eval-only per-process split (strided over the shared-seed order —
        # the reference's DistributedSampler role, sampler.py:64-115); set
        # before super() so the single refresh_ids pass builds the shard
        self.shard_index = shard_index
        self.shard_count = shard_count
        super().__init__(txt_db, img_db, **kw)

    def size_of(self, i):
        # cached like ReDataset.size_of: spec_from_dataset + the loader's
        # sampler both run a full size pass; without the cache each call
        # decompresses the text record just to read image_id
        sid = self.ids[i]
        cache = getattr(self, "_sid2nbb", None)
        if cache is None:
            cache = self._sid2nbb = {}
        nbb = cache.get(sid)
        if nbb is None:
            iid = self.txt_db[sid]["image_id"]
            f = gt_fname(iid) if self.use_gt_feat else det_fname(iid)
            nbb = cache[sid] = self.img_db.name2nbb[f]
        return self.txt_lens[i] + 2, nbb

    def get_record(self, i: int, rng=None):
        ex = self.txt_db[self.ids[i]]
        image_id = ex["image_id"]
        fname = (gt_fname(image_id) if self.use_gt_feat
                 else det_fname(image_id))
        feat, pos7, num_bb = self.img_db.get_img_feat(fname)
        input_ids = self.txt_db.combine_inputs(ex["input_ids"])
        img = self.txt_db.Images[image_id]
        w, h = img["width"], img["height"]
        obj_boxes = np.stack(
            [pos7[:, 0] * w, pos7[:, 1] * h, pos7[:, 4] * w, pos7[:, 5] * h],
            axis=1)
        return dict(input_ids=input_ids, img_feat=feat, img_pos_feat=pos7,
                    tgt_box=np.asarray(ex["bbox"], np.float32),
                    obj_boxes=obj_boxes, sent_id=self.ids[i])

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        batch = collate_joint(records, t_bucket, r_bucket, batch_size)
        batch["obj_masks"] = ~batch["attn_mask"][:, t_bucket:].astype(bool)
        batch["tgt_box"] = [r["tgt_box"] for r in records]
        batch["obj_boxes"] = [r["obj_boxes"] for r in records]
        batch["sent_ids"] = [r["sent_id"] for r in records]
        return batch
