"""MLM pretraining dataset (reference data/mlm.py; a copy of
``uniter_tpu/data/mlm.py`` over the port's data layer).

``random_word``: 15% of tokens selected; 80% -> [MASK], 10% -> random vocab
token, 10% kept; at least one position always masked (data/mlm.py:17-54).
Randomness comes from an explicit numpy RandomState so host-side data order
is reproducible and multi-host consistent.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from uniter_tpu_torch.data.buckets import collate_joint, slots_from_labels
from uniter_tpu_torch.data.datasets import JointDataset


def random_word(tokens, vocab_range, mask, rng: np.random.RandomState):
    tokens = list(tokens)
    labels = []
    for i, tok in enumerate(tokens):
        prob = rng.random_sample()
        if prob < 0.15:
            prob /= 0.15
            if prob < 0.8:
                tokens[i] = mask
            elif prob < 0.9:
                tokens[i] = int(rng.randint(vocab_range[0], vocab_range[1]))
            labels.append(tok)
        else:
            labels.append(-1)
    if all(l == -1 for l in labels):
        labels[0] = tokens[0]
        tokens[0] = mask
    return tokens, labels


def mlm_slots(t_bucket: int) -> int:
    """Static masked-slot count: cap at 24% of the bucket + 1 (15% expected;
    overflow truncation is negligible and deterministic)."""
    return max(1, math.ceil(0.24 * t_bucket) + 1)


class MlmDataset(JointDataset):
    def get_record(self, i: int, rng: np.random.RandomState) -> Dict:
        ex = self.example(i)
        tokens, labels = random_word(
            ex["input_ids"], self.txt_db.v_range, self.txt_db.mask, rng)
        input_ids = np.asarray(
            [self.txt_db.cls_] + tokens + [self.txt_db.sep], np.int32)
        txt_labels = np.asarray([-1] + labels + [-1], np.int32)
        feat, pos7, _ = self.img_feat(i)
        return dict(input_ids=input_ids, img_feat=feat, img_pos_feat=pos7,
                    txt_labels=txt_labels)

    @staticmethod
    def collate(records, t_bucket, r_bucket, batch_size):
        batch = collate_joint(
            records, t_bucket, r_bucket, batch_size,
            fields={"txt_labels": ("txt", -1)},
        )
        pos, tgt = slots_from_labels(
            batch.pop("txt_labels"), mlm_slots(t_bucket))
        batch["mlm_pos"] = pos
        batch["mlm_tgt"] = tgt
        return batch
