"""NLVR2 datasets (reference data/nlvr2.py; a copy of
``uniter_tpu/data/nlvr2.py`` over the port's data layer).

Paired: each example yields 2 consecutive rows (text + left img, text +
right img) with img_type_ids 1/2; the model pairs rows (2i, 2i+1). Triplet:
both images concatenated into one row's region segment. Eval variants carry
qids (the example identifiers) host-side.
"""

from __future__ import annotations

from typing import List

import numpy as np

from uniter_tpu_torch.data.buckets import collate_joint
from uniter_tpu_torch.data.datasets import JointDataset


class Nlvr2PairedDataset(JointDataset):
    rows_per_example = 2

    def __init__(self, txt_db, img_db, use_img_type=True, **kw):
        # lens: 2*txt + both images' boxes (reference nlvr2.py:27-29)
        self.use_img_type = use_img_type
        super().__init__(txt_db, img_db, **kw)
        txt2img = txt_db.txt2img
        self.img_fnames = [txt2img[i] for i in self.ids]  # pair lists
        self.lens = [
            2 * tl + sum(img_db.name2nbb[f] for f in pair)
            for tl, pair in zip(self.txt_lens, self.img_fnames)
        ]

    def size_of(self, i):
        pair = self.img_fnames[i]
        nbb = max(self.img_db.name2nbb[f] for f in pair)
        return self.txt_lens[i] + 2, nbb

    def get_record(self, i: int, rng=None) -> List[dict]:
        """Returns the 2 rows for example i."""
        ex = self.example(i)
        input_ids = self.txt_db.combine_inputs(ex["input_ids"])
        rows = []
        for k, fname in enumerate(ex["img_fname"]):
            feat, pos7, nbb = self.img_db.get_img_feat(fname)
            row = dict(input_ids=input_ids, img_feat=feat, img_pos_feat=pos7)
            if self.use_img_type:
                row["img_type_ids"] = np.full((nbb,), k + 1, np.int32)
            rows.append(row)
        return dict(rows=rows,
                    # unlabeled leaderboard splits carry target=None
                    # (prepro.py test2 case): -1. Inference ignores targets;
                    # validation excludes target<0 rows from accuracy.
                    # Unlabeled DBs are not valid TRAINING inputs.
                    target=-1 if ex["target"] is None
                    else int(ex["target"]),
                    qid=self.ids[i])

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        rows = [r for rec in records for r in rec["rows"]]
        batch = collate_joint(
            rows, t_bucket, r_bucket, batch_size * 2,
            fields={"img_type_ids": ("img", 0)},
        )
        targets = np.zeros((batch_size,), np.int32)
        pair_weight = np.zeros((batch_size,), np.float32)
        for i, rec in enumerate(records):
            targets[i] = rec["target"]
            pair_weight[i] = 1.0
        batch["targets"] = targets
        batch["ex_weight"] = pair_weight  # per-pair weight for the loss
        batch["qids"] = [rec["qid"] for rec in records]
        return batch


class Nlvr2TripletDataset(JointDataset):
    rows_per_example = 1

    def __init__(self, txt_db, img_db, use_img_type=True, **kw):
        self.use_img_type = use_img_type
        super().__init__(txt_db, img_db, **kw)
        txt2img = txt_db.txt2img
        self.img_fnames = [txt2img[i] for i in self.ids]
        self.lens = [
            tl + sum(img_db.name2nbb[f] for f in pair)
            for tl, pair in zip(self.txt_lens, self.img_fnames)
        ]

    def size_of(self, i):
        pair = self.img_fnames[i]
        nbb = sum(self.img_db.name2nbb[f] for f in pair)
        return self.txt_lens[i] + 2, nbb

    def get_record(self, i: int, rng=None) -> dict:
        ex = self.example(i)
        input_ids = self.txt_db.combine_inputs(ex["input_ids"])
        feats, poss, types = [], [], []
        for k, fname in enumerate(ex["img_fname"]):
            feat, pos7, nbb = self.img_db.get_img_feat(fname)
            feats.append(feat)
            poss.append(pos7)
            types.append(np.full((nbb,), k + 1, np.int32))
        rec = dict(
            input_ids=input_ids,
            img_feat=np.concatenate(feats, 0),
            img_pos_feat=np.concatenate(poss, 0),
            target=-1 if ex["target"] is None else int(ex["target"]),
            qid=self.ids[i],
        )
        if self.use_img_type:
            rec["img_type_ids"] = np.concatenate(types, 0)
        return rec

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        batch = collate_joint(
            records, t_bucket, r_bucket, batch_size,
            fields={"img_type_ids": ("img", 0)},
        )
        batch["targets"] = np.asarray(
            [r["target"] for r in records]
            + [0] * (batch_size - len(records)), np.int32)
        batch["qids"] = [r["qid"] for r in records]
        return batch
