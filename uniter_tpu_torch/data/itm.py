"""ITM pretraining dataset (reference data/itm.py; a copy of the
``ItmDataset`` part of ``uniter_tpu/data/itm.py`` over the port's data
layer).

``ItmDataset``: pretraining ITM with per-epoch negative resampling
(new_epoch, reference itm.py:65-78); targets 1 (match) / 0 (negative),
-1 at the collate's padding rows. The fine-tune rank datasets and the
retrieval evaluation datasets of the JAX module are not ported yet.

All sampling uses explicit numpy RandomStates.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from uniter_tpu_torch.data.buckets import collate_joint
from uniter_tpu_torch.data.datasets import JointDataset


def _has_overlap(la, lb):
    if len(la) < len(lb):
        la, lb = lb, la
    s = set(la)
    return any(b in s for b in lb)


def sample_negative(pool, ground_truths, num_sample,
                    rng: np.random.RandomState):
    """random-and-retry (reference itm.py:41-46)."""
    out = list(ground_truths[:1])
    while _has_overlap(out, ground_truths):
        idx = rng.choice(len(pool), size=num_sample, replace=False)
        out = [pool[int(j)] for j in idx]
    return out


class ItmDataset(JointDataset):
    def __init__(self, txt_db, img_db, neg_sample_p=0.5, **kw):
        super().__init__(txt_db, img_db, **kw)
        self.neg_sample_p = neg_sample_p
        self.all_imgs = sorted(set(self.img_fnames))
        self.new_epoch(np.random.RandomState(0))

    def new_epoch(self, rng: np.random.RandomState):
        """re-sample negative pairings (reference itm.py:65-78)."""
        n = len(self.ids)
        self.labels = (rng.random_sample(n) >= self.neg_sample_p).astype(int)
        self.train_imgs = []
        self.lens = []
        txt2img = {i: f for i, f in zip(self.ids, self.img_fnames)}
        for i, (id_, tl) in enumerate(zip(self.ids, self.txt_lens)):
            fname = txt2img[id_]
            if self.labels[i] == 0:
                fname = sample_negative(self.all_imgs, [fname], 1, rng)[0]
            self.train_imgs.append(fname)
            self.lens.append(tl + self.img_db.name2nbb[fname])

    def size_of(self, i):
        return self.txt_lens[i] + 2, self.img_db.name2nbb[self.train_imgs[i]]

    def get_record(self, i: int, rng=None) -> Dict:
        ex = self.example(i)
        input_ids = self.txt_db.combine_inputs(ex["input_ids"])
        feat, pos7, _ = self.img_db.get_img_feat(self.train_imgs[i])
        return dict(input_ids=input_ids, img_feat=feat, img_pos_feat=pos7,
                    target=int(self.labels[i]))

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        batch = collate_joint(records, t_bucket, r_bucket, batch_size)
        targets = np.full((batch_size,), -1, np.int32)  # -1: padding rows
        for i, r in enumerate(records):
            targets[i] = r["target"]
        batch["targets"] = targets
        return batch
