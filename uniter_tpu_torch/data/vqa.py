"""VQA / SNLI-VE datasets (reference data/vqa.py, data/ve.py).

The soft target vector scatters answer scores into num_answers slots
(data/vqa.py:14-20); VE is the 3-answer alias (data/ve.py:11-22).
"""

from __future__ import annotations

import numpy as np

from uniter_tpu_torch.data.buckets import collate_joint
from uniter_tpu_torch.data.datasets import JointDataset


def get_vqa_target(example, num_answers) -> np.ndarray:
    target = np.zeros((num_answers,), np.float32)
    t = example.get("target") or {}
    labels, scores = t.get("labels"), t.get("scores")
    if labels and scores:
        target[np.asarray(labels)] = np.asarray(scores, np.float32)
    return target


class VqaDataset(JointDataset):
    def __init__(self, num_answers, *args, **kw):
        super().__init__(*args, **kw)
        self.num_answers = num_answers

    def get_record(self, i: int, rng=None) -> dict:
        ex = self.example(i)
        input_ids = self.txt_db.combine_inputs(ex["input_ids"])
        feat, pos7, _ = self.img_feat(i)
        return dict(
            input_ids=input_ids, img_feat=feat, img_pos_feat=pos7,
            target=get_vqa_target(ex, self.num_answers), qid=self.ids[i],
        )

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        batch = collate_joint(records, t_bucket, r_bucket, batch_size)
        n_ans = records[0]["target"].shape[0]
        targets = np.zeros((batch_size, n_ans), np.float32)
        for i, r in enumerate(records):
            targets[i] = r["target"]
        batch["targets"] = targets
        batch["qids"] = [r["qid"] for r in records]
        return batch


class VeDataset(VqaDataset):
    """SNLI-VE: 3 answers (reference data/ve.py:11-16)."""

    def __init__(self, *args, **kw):
        super().__init__(3, *args, **kw)
