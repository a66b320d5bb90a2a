"""VCR datasets (reference data/vcr.py; a copy of ``uniter_tpu/data/vcr.py``
over the port's data layer).

  * ``VcrTxtTokDb`` — VCR text DB with task-specific id2len files
    (id2len_qa.json / id2len_qar.json) (vcr.py:18-45).
  * ``VcrDataset`` — one row per answer choice with txt_type_ids
    (0 question / 2 answer / 3 rationale; region rows use img type 1)
    (vcr.py:96-159); dual img_db: gt + detected features concatenated
    (vcr.py:47-94).
  * ``VcrEvalDataset`` — qa + qar candidate expansion; val conditions the
    rationale candidates on the gold answer (vcr.py:196-258).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

from uniter_tpu_torch.data.buckets import collate_joint
from uniter_tpu_torch.data.datasets import JointDataset, shard_ids
from uniter_tpu_torch.data.txt_db import TxtTokDb

if TYPE_CHECKING:
    from uniter_tpu_torch.data.img_db import DetectFeatDb


class VcrTxtTokDb(TxtTokDb):
    def __init__(self, db_dir, max_txt_len=120, task="qa,qar", **kw):
        assert task in ("qa", "qar", "qa,qar")
        id2len_task = "qar" if task == "qa,qar" else task
        super().__init__(
            db_dir, max_txt_len,
            id2len_file=f"id2len_{id2len_task}.json", **kw)
        self.task = task


class VcrJointDataset(JointDataset):
    """Dual-image-db base (gt + det features concatenated)."""

    def __init__(self, txt_db: VcrTxtTokDb,
                 img_db_gt: Optional[DetectFeatDb] = None,
                 img_db: Optional[DetectFeatDb] = None,
                 shard_index: int = 0, shard_count: int = 1):
        assert img_db_gt is not None or img_db is not None
        self.txt_db = txt_db
        self.img_db = img_db
        self.img_db_gt = img_db_gt
        self.task = txt_db.task
        self.ids = shard_ids(txt_db.id2len.keys(), shard_index, shard_count)
        self.txt_lens = [txt_db.id2len[i] for i in self.ids]
        txt2img = txt_db.txt2img
        self.img_fnames = [txt2img[i] for i in self.ids]

        def nbb(pair):
            n = 0
            if img_db_gt is not None:
                n += img_db_gt.name2nbb[pair[0]]
            if img_db is not None:
                n += img_db.name2nbb[pair[1]]
            return n

        self.lens = [tl + nbb(p)
                     for tl, p in zip(self.txt_lens, self.img_fnames)]
        self._nbbs = [nbb(p) for p in self.img_fnames]

    def size_of(self, i):
        return self.txt_lens[i] + 2, self._nbbs[i]

    def joint_img_feat(self, i):
        pair = self.img_fnames[i]
        feats, poss = [], []
        if self.img_db_gt is not None:
            f, p, _ = self.img_db_gt.get_img_feat(pair[0])
            feats.append(f)
            poss.append(p)
        if self.img_db is not None:
            f, p, _ = self.img_db.get_img_feat(pair[1])
            feats.append(f)
            poss.append(p)
        feat = np.concatenate(feats, 0)
        pos = np.concatenate(poss, 0)
        return feat, pos, feat.shape[0]


class VcrDataset(VcrJointDataset):
    """Training: one row per answer (or rationale) choice."""

    NUM_CHOICES = 4
    rows_per_example = 4

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        assert self.task != "qa,qar", "train one task at a time"

    def size_of(self, i):
        # +2 specials; choice text adds to id2len already (id2len counts the
        # longest qa/qar variant)
        return self.txt_lens[i] + 4, self._nbbs[i]

    def _question(self, ex):
        input_ids_q = list(ex["input_ids"])
        type_ids_q = [0] * len(input_ids_q)
        if self.task == "qar":
            answer_label = ex["qa_target"]
            assert answer_label >= 0
            gt_a = [self.txt_db.sep] + list(ex["input_ids_as"][answer_label])
            input_ids_q += gt_a
            type_ids_q += [2] * len(gt_a)
            choices = ex["input_ids_rs"]
        else:
            choices = ex["input_ids_as"]
        return input_ids_q, choices, type_ids_q

    def get_record(self, i: int, rng=None):
        ex = self.example(i)
        feat, pos7, _ = self.joint_img_feat(i)
        q_ids, choices, q_types = self._question(ex)
        label = ex[f"{self.task}_target"]
        rows = []
        for idx, a_ids in enumerate(choices):
            choice_type = 3 if (q_types and q_types[-1] == 2) else 2
            input_ids = ([self.txt_db.cls_] + list(q_ids)
                         + [self.txt_db.sep] + list(a_ids)
                         + [self.txt_db.sep])
            txt_type_ids = ([0] + q_types
                            + [choice_type] * (len(a_ids) + 2))
            rows.append(dict(
                input_ids=np.asarray(input_ids, np.int32),
                txt_type_ids=np.asarray(txt_type_ids, np.int32),
                img_feat=feat, img_pos_feat=pos7,
                target=int(idx == label),
            ))
        return dict(rows=rows, qid=self.ids[i])

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        rows = [r for rec in records for r in rec["rows"]]
        n_rows = batch_size * VcrDataset.NUM_CHOICES
        batch = collate_joint(
            rows, t_bucket, r_bucket, n_rows,
            fields={"txt_type_ids": ("txt", 0)},
        )
        targets = np.zeros((n_rows,), np.int32)
        for i, r in enumerate(rows):
            targets[i] = r["target"]
        batch["targets"] = targets
        batch["qids"] = [rec["qid"] for rec in records]
        return batch


class VcrEvalDataset(VcrJointDataset):
    """Eval: 4 qa rows + 4 (val: gold-answer-conditioned) or 16 (test) qar
    rows per example."""

    def __init__(self, split, *args, **kw):
        super().__init__(*args, **kw)
        self.split = split
        assert self.task == "qa,qar"
        # every example expands to a fixed row count (4 qa + 4 gold-answer
        # qar rows on val; 4 qa + 16 qar on test): declare it so the
        # sampler plans real token budgets — without this a batch_size=N
        # plan dispatches N*8 (val) / N*20 (test) rows
        self.rows_per_example = 8 if split == "val" else 20

    def size_of(self, i):
        return self.txt_lens[i] + 6, self._nbbs[i]

    def get_record(self, i: int, rng=None):
        ex = self.example(i)
        feat, pos7, _ = self.joint_img_feat(i)
        q = list(ex["input_ids"])
        rows = []
        for a_ids in ex["input_ids_as"]:
            ids = ([self.txt_db.cls_] + q + [self.txt_db.sep]
                   + list(a_ids) + [self.txt_db.sep])
            types = [0] * (len(q) + 1) + [2] * (len(a_ids) + 2)
            rows.append((ids, types))
        for idx, a_ids in enumerate(ex["input_ids_as"]):
            if not (self.split == "test"
                    or (self.split == "val" and idx == ex["qa_target"])):
                continue
            base = ([self.txt_db.cls_] + q + [self.txt_db.sep]
                    + list(a_ids) + [self.txt_db.sep])
            base_t = [0] * (len(q) + 1) + [2] * (len(a_ids) + 1)
            for r_ids in ex["input_ids_rs"]:
                ids = base + list(r_ids) + [self.txt_db.sep]
                types = base_t + [3] * (len(r_ids) + 2)
                rows.append((ids, types))
        recs = [dict(input_ids=np.asarray(ids, np.int32),
                     txt_type_ids=np.asarray(types, np.int32),
                     img_feat=feat, img_pos_feat=pos7)
                for ids, types in rows]
        return dict(rows=recs, qid=self.ids[i],
                    qa_target=int(ex["qa_target"]),
                    qar_target=int(ex["qar_target"]))

    def collate_fn(self, records, t_bucket, r_bucket, batch_size=None):
        """Shape-stable collate: the row axis pads to the PLANNED size
        (batch_size examples x the split's declared rows_per_example), so
        tail batches reuse the same compiled program; padding rows are
        masked by collate_joint's ex_weight. Pass this (bound) method as
        the loader's collate."""
        rows = [r for rec in records for r in rec["rows"]]
        n_rows = (batch_size * self.rows_per_example if batch_size
                  else len(rows))
        batch = collate_joint(
            rows, t_bucket, r_bucket, n_rows,
            fields={"txt_type_ids": ("txt", 0)},
        )
        batch["qids"] = [rec["qid"] for rec in records]
        batch["n_rows"] = [len(rec["rows"]) for rec in records]
        batch["qa_targets"] = np.asarray(
            [rec["qa_target"] for rec in records], np.int32)
        batch["qar_targets"] = np.asarray(
            [rec["qar_target"] for rec in records], np.int32)
        return batch
