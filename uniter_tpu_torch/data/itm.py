"""ITM / retrieval datasets (reference data/itm.py; a copy of
``uniter_tpu/data/itm.py`` over the port's data layer: with the same seeds
the records and collates are the JAX module's, bit for bit).

  * ``ItmDataset`` — pretraining ITM with per-epoch negative resampling
    (new_epoch, reference itm.py:65-78); targets 1 (match) / 0 (negative),
    -1 at the collate's padding rows.
  * ``ItmRankDataset`` — fine-tune groups of (1 pos + 2*neg) pairs
    (itm.py:187-238).
  * ``ItmRankDatasetHardNegFromText/Image`` — one example builds a whole
    (1 + neg_sample_size)-candidate batch sharing the text (resp. image)
    (itm.py:271-366); the model mines hard negatives in the step.
  * ``ItmValDataset`` / ``ItmEvalDataset`` — retrieval evaluation: one text
    against a window of / all images, emitted as fixed-shape minibatches
    (itm.py:377-468).

All sampling uses explicit numpy RandomStates.
"""

from __future__ import annotations

from typing import Dict, List

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


class ItmRankDataset(JointDataset):
    def __init__(self, txt_db, img_db, neg_sample_size=1, **kw):
        assert neg_sample_size > 0
        super().__init__(txt_db, img_db, **kw)
        self.txt2img = {i: f for i, f in zip(self.ids, self.img_fnames)}
        self.img2txts = {}
        for id_, img in self.txt2img.items():
            self.img2txts.setdefault(img, []).append(id_)
        self.img_name_list = sorted(self.img2txts.keys())
        self.neg_sample_size = neg_sample_size

    def get_record(self, i: int, rng: np.random.RandomState) -> Dict:
        gt_txt = self.ids[i]
        gt_img = self.txt2img[gt_txt]
        pairs = [(gt_txt, gt_img)]
        neg_imgs = sample_negative(
            self.img_name_list, [gt_img], self.neg_sample_size, rng)
        neg_txts = sample_negative(
            self.ids, self.img2txts[gt_img], self.neg_sample_size, rng)
        pairs += [(gt_txt, im) for im in neg_imgs]
        pairs += [(t, gt_img) for t in neg_txts]
        rows = []
        for t, im in pairs:
            ids = self.txt_db.combine_inputs(self.txt_db[t]["input_ids"])
            feat, pos7, _ = self.img_db.get_img_feat(im)
            rows.append(dict(input_ids=ids, img_feat=feat, img_pos_feat=pos7))
        return dict(rows=rows)

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        sample_size = len(records[0]["rows"])
        rows = [r for rec in records for r in rec["rows"]]
        batch = collate_joint(
            rows, t_bucket, r_bucket, batch_size * sample_size)
        batch["sample_size"] = sample_size
        return batch


class _HardNegBase(JointDataset):
    def __init__(self, txt_db, img_db, neg_sample_size=1, **kw):
        assert neg_sample_size > 0
        super().__init__(txt_db, img_db, **kw)
        self.txt2img = {i: f for i, f in zip(self.ids, self.img_fnames)}
        self.img2txts = txt_db.img2txts
        self.img_name_list = sorted(self.img2txts.keys())
        self.txt_name_list = list(self.txt2img.keys())
        self.neg_sample_size = neg_sample_size


class ItmRankDatasetHardNegFromText(_HardNegBase):
    """1 text x (1 gt + N neg images) — candidate batch in one record."""

    def get_record(self, i: int, rng: np.random.RandomState) -> Dict:
        gt_txt = self.ids[i]
        gt_img = self.txt2img[gt_txt]
        input_ids = self.txt_db.combine_inputs(
            self.txt_db[gt_txt]["input_ids"])
        img_ids = [gt_img] + sample_negative(
            self.img_name_list, [gt_img], self.neg_sample_size, rng)
        rows = []
        for im in img_ids:
            feat, pos7, _ = self.img_db.get_img_feat(im)
            rows.append(dict(input_ids=input_ids, img_feat=feat,
                             img_pos_feat=pos7))
        return dict(rows=rows)


class ItmRankDatasetHardNegFromImage(_HardNegBase):
    """1 image x (1 gt + N neg texts)."""

    def get_record(self, i: int, rng: np.random.RandomState) -> Dict:
        gt_txt = self.ids[i]
        gt_img = self.txt2img[gt_txt]
        gt_txts = self.img2txts[gt_img]
        feat, pos7, _ = self.img_db.get_img_feat(gt_img)
        txt_ids = [gt_txt] + sample_negative(
            self.txt_name_list, gt_txts, self.neg_sample_size, rng)
        rows = []
        for t in txt_ids:
            ids = self.txt_db.combine_inputs(self.txt_db[t]["input_ids"])
            rows.append(dict(input_ids=ids, img_feat=feat, img_pos_feat=pos7))
        return dict(rows=rows)


def hard_neg_collate(record, t_bucket, r_bucket):
    """One record (the candidate set) -> one fixed-shape batch."""
    rows = record["rows"]
    return collate_joint(rows, t_bucket, r_bucket, len(rows))


class ItmValDataset(JointDataset):
    """One text vs a window of images (gt first) (itm.py:377-451)."""

    def __init__(self, txt_db, img_db, mini_batch_size=400, **kw):
        super().__init__(txt_db, img_db, **kw)
        self.txt2img = {i: f for i, f in zip(self.ids, self.img_fnames)}
        self.img2txts = txt_db.img2txts
        self.all_img_ids = list(self.img2txts.keys())
        self._img_pos = {im: j for j, im in enumerate(self.all_img_ids)}
        self.bs = min(mini_batch_size, len(self.all_img_ids))

    def bucket_hint(self):
        """(t_bucket, r_bucket) covering the dataset's real sizes."""
        max_t = max(self.txt_lens, default=30) + 2  # +[CLS]/[SEP]
        max_r = max((self.img_db.name2nbb[im] for im in self.all_img_ids),
                    default=4)
        return ((max_t + 7) // 8) * 8, ((max_r + 3) // 4) * 4

    def _window(self, i) -> List[str]:
        gt_img = self.txt2img[self.ids[i]]
        j = self._img_pos[gt_img]
        neg = [
            self.all_img_ids[(j + 1 + k) % len(self.all_img_ids)]
            for k in range(self.bs - 1)
        ]
        return [gt_img] + neg

    def batch_for(self, i: int, img_ids: List[str], t_bucket, r_bucket,
                  pad_to: int = 0):
        """``pad_to``: fixed batch size (ragged tail windows pad with
        ex_weight-0 rows, so every window of a bucket has one shape)."""
        ids = self.txt_db.combine_inputs(self.example(i)["input_ids"])
        rows = []
        for im in img_ids:
            feat, pos7, _ = self.img_db.get_img_feat(im)
            rows.append(dict(input_ids=ids, img_feat=feat, img_pos_feat=pos7))
        return collate_joint(rows, t_bucket, r_bucket,
                             max(pad_to, len(rows)))

    def get_batches(self, i: int, t_bucket, r_bucket):
        return [self.batch_for(i, self._window(i), t_bucket, r_bucket)]


class ItmEvalDataset(ItmValDataset):
    """One text vs ALL images, nbb-sorted minibatches (itm.py:454-468)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.all_img_ids = sorted(
            self.all_img_ids, key=lambda i: self.img_db.name2nbb[i])
        self._img_pos = {im: j for j, im in enumerate(self.all_img_ids)}

    def get_batches(self, i: int, t_bucket, r_bucket):
        out = []
        for st in range(0, len(self.all_img_ids), self.bs):
            window = self.all_img_ids[st:st + self.bs]
            out.append(self.batch_for(i, window, t_bucket, r_bucket,
                                      pad_to=self.bs))
        return out
