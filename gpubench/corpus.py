"""Raw data of the traffic, made from seeds.

An image corpus is a fixed function of its ``corpus_seed`` (a key of the
mix file): ``n_img`` images of lo..hi regions, each region's fp16 2048-d
feature cut from one seeded pool, fp16 boxes, confidences above every
threshold and, for pretraining, 1601-way soft labels. It is the same in
every run of a mix, so it is written once a checkout. A text corpus is a
function of the run's seed: the words of ``n_txt`` captions or
questions and, for VQA, one to a few answer labels with their soft
scores; their lengths and images are fixed by the mix, so that every
run does the same work. Both sides read the same arrays: the
program through the DBs the port's writers make of them, the reference
from these objects.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, List

import numpy as np

POOL_ROWS = 8192
SOFT_ROWS = 4096
FEAT_DIM = 2048
LABEL_DIM = 1601
META = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [999, 28996]}
VQA_SCORES = (0.3, 0.6, 0.9, 1.0)


class ImageCorpus:
    def __init__(self, seed: int, n_img: int, regions, soft: bool):
        lo, hi = regions
        rng = np.random.default_rng(seed)
        self.pool = rng.standard_normal((POOL_ROWS, FEAT_DIM),
                                        dtype=np.float32).astype(np.float16)
        self.nbb = rng.integers(lo, hi + 1, n_img)
        self.off = rng.integers(0, POOL_ROWS - hi, n_img)
        self.boxes = rng.random((n_img, hi, 6), dtype=np.float32).astype(
            np.float16)
        self.soft = None
        if soft:
            s = rng.random((SOFT_ROWS, LABEL_DIM), dtype=np.float32)
            self.soft = (s / s.sum(-1, keepdims=True)).astype(np.float16)
            self.soft_off = rng.integers(0, SOFT_ROWS - hi, n_img)
        self.names = [f"img_{j:06d}.npz" for j in range(n_img)]
        self.index = {n: j for j, n in enumerate(self.names)}

    def __len__(self):
        return len(self.names)

    def record(self, j: int) -> Dict[str, np.ndarray]:
        n = int(self.nbb[j])
        rec = dict(features=self.pool[self.off[j]:self.off[j] + n],
                   norm_bb=self.boxes[j, :n],
                   conf=np.linspace(1, 0.3, n).astype(np.float16))
        rec["soft_labels"] = (
            self.soft[self.soft_off[j]:self.soft_off[j] + n]
            if self.soft is not None else np.zeros((n, LABEL_DIM), np.float16))
        return rec

    def feat_pos(self, name: str):
        """(fp16 features [n, 2048], fp32 7-d box geometry [n, 7]) of an
        image as the published loader makes them: the six box values and
        the box's area (width x height)."""
        rec = self.record(self.index[name])
        bb = rec["norm_bb"].astype(np.float32)
        return rec["features"], np.concatenate([bb, bb[:, 4:5] * bb[:, 5:6]],
                                               -1)


class TextCorpus:
    """Texts over the image corpus: their lengths (lo..hi word ids) and
    images are a function of ``layout_seed`` (the mix's), their words and,
    with ``num_answer``, answer labels and soft scores of ``seed`` (the
    run's). So every run of a mix does the same amount of work."""

    def __init__(self, seed: int, n_txt: int, lengths, images: ImageCorpus,
                 num_answer: int = 0, labels_per_text=(1, 3), prefix="t",
                 layout_seed: int = 0):
        layout = np.random.default_rng(layout_seed)
        rng = np.random.default_rng(seed)
        lo, hi = lengths
        vlo, vhi = META["v_range"]
        self.ids: List[str] = [f"{prefix}{i:06d}" for i in range(n_txt)]
        lens = layout.integers(lo, hi + 1, n_txt)
        self.img = [images.names[int(j)]
                    for j in layout.integers(0, len(images), n_txt)]
        self.tokens = [rng.integers(vlo, vhi, int(n)).astype(np.int32)
                       for n in lens]
        self.targets = None
        if num_answer:
            self.targets = []
            for _ in range(n_txt):
                k = int(rng.integers(labels_per_text[0],
                                     labels_per_text[1] + 1))
                labels = rng.choice(num_answer, size=k, replace=False)
                scores = rng.choice(VQA_SCORES, size=k)
                self.targets.append((labels.astype(int).tolist(),
                                     scores.astype(float).tolist()))
        self.index = {t: i for i, t in enumerate(self.ids)}

    def records(self) -> Dict[str, dict]:
        out = {}
        for i, t in enumerate(self.ids):
            rec = {"input_ids": self.tokens[i].tolist(),
                   "img_fname": self.img[i]}
            if self.targets is not None:
                labels, scores = self.targets[i]
                rec["target"] = {"labels": labels, "scores": scores}
            out[t] = rec
        return out

    def with_specials(self, i: int) -> np.ndarray:
        return np.concatenate([[META["CLS"]], self.tokens[i],
                               [META["SEP"]]]).astype(np.int32)


def _spec_key(spec: dict) -> str:
    return hashlib.sha256(json.dumps(spec, sort_keys=True).encode()
                          ).hexdigest()[:16]


def write_image_db(root: str, corpus: ImageCorpus, spec: dict) -> str:
    """The img DB of ``corpus`` under ``root``, written by the port's
    writer once for each ``spec`` (reused while its marker stands)."""
    from uniter_tpu_torch.data.img_db import write_img_db

    path = os.path.join(root, f"img-{_spec_key(spec)}")
    marker = os.path.join(path, "complete")
    if os.path.exists(marker):
        return path
    shutil.rmtree(path, ignore_errors=True)
    write_img_db(path, ((n, corpus.record(j))
                        for j, n in enumerate(corpus.names)),
                 conf_th=0.2, max_bb=100, min_bb=10)
    with open(marker, "w") as f:
        f.write("ok\n")
    return path


def write_text_db(path: str, corpus: TextCorpus) -> str:
    """The txt DB of ``corpus`` at ``path`` (replacing what is there), by
    the port's writer."""
    from uniter_tpu_torch.data.txt_db import write_txt_db

    shutil.rmtree(path, ignore_errors=True)
    write_txt_db(path, corpus.records(), META,
                 {t: corpus.img[i] for i, t in enumerate(corpus.ids)},
                 store="lmdb")
    return path
