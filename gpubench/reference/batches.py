"""The reference's own batches, rebuilt from the corpus's raw arrays.

A program batch names its rows (VQA's question ids, or the records the
harness's datasets tag) and has a bucket shape (T, R); the reference lays
the same rows out in that shape itself: [CLS] words [SEP] then padding,
the image's regions then padding, the 0/1 validity mask over both
segments, and the task's targets. Masks the program drew from a record's
random stream are drawn again here from that stream's saved state, with
the published rules (ChenRocks/UNITER data/mlm.py ``random_word``,
data/mrm.py ``_get_img_mask``). The check then compares every array of
the program's batch with this one.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from gpubench.corpus import META, ImageCorpus, TextCorpus


def joint_rows(rows: List[tuple], t_b: int, r_b: int,
               images: ImageCorpus) -> Dict[str, np.ndarray]:
    """``rows``: (token ids with CLS/SEP, image name, img_feat override or
    None) per real row; the batch has len(rows) rows."""
    bs = len(rows)
    feat_dtype = np.float16
    for _, _, over in rows:
        if over is not None:
            feat_dtype = over.dtype
    out = {"input_ids": np.zeros((bs, t_b), np.int32),
           "position_ids": np.tile(np.arange(t_b, dtype=np.int32), (bs, 1)),
           "img_feat": np.zeros((bs, r_b, 2048), feat_dtype),
           "img_pos_feat": np.zeros((bs, r_b, 7), np.float32),
           "attn_mask": np.zeros((bs, t_b + r_b), np.int32),
           "ex_weight": np.ones((bs,), np.float32),
           "txt_lens": np.zeros((bs,), np.int32),
           "num_bbs": np.zeros((bs,), np.int32)}
    for i, (ids, name, over) in enumerate(rows):
        tl = min(len(ids), t_b)
        out["input_ids"][i, :tl] = ids[:tl]
        feat, pos = images.feat_pos(name)
        if over is not None:
            feat = over
        nbb = min(len(feat), r_b)
        out["img_feat"][i, :nbb] = feat[:nbb]
        out["img_pos_feat"][i, :nbb] = pos[:nbb]
        out["attn_mask"][i, :tl] = 1
        out["attn_mask"][i, t_b:t_b + nbb] = 1
        out["txt_lens"][i], out["num_bbs"][i] = tl, nbb
    return out


def vqa_batch(qids: List[str], t_b: int, r_b: int, texts: TextCorpus,
              images: ImageCorpus, num_answer: int) -> Dict[str, np.ndarray]:
    idx = [texts.index[q] for q in qids]
    out = joint_rows([(texts.with_specials(i), texts.img[i], None)
                      for i in idx], t_b, r_b, images)
    tg = np.zeros((len(idx), num_answer), np.float32)
    for row, i in enumerate(idx):
        labels, scores = texts.targets[i]
        tg[row, labels] = np.asarray(scores, np.float32)
    out["targets"] = tg
    return out


# ---- pretraining ------------------------------------------------------------

def random_word(tokens, rs: np.random.RandomState):
    """15% of the words chosen; of those 80% [MASK], 10% a random word, 10%
    kept; at least the first masked when none was chosen."""
    tokens, labels = list(tokens), []
    for i, tok in enumerate(tokens):
        p = rs.random_sample()
        if p < 0.15:
            p /= 0.15
            if p < 0.8:
                tokens[i] = META["MASK"]
            elif p < 0.9:
                tokens[i] = int(rs.randint(*META["v_range"]))
            labels.append(tok)
        else:
            labels.append(-1)
    if all(x == -1 for x in labels):
        labels[0] = tokens[0]
        tokens[0] = META["MASK"]
    return tokens, labels


def img_mask(prob: float, n: int, rs: np.random.RandomState) -> np.ndarray:
    m = rs.random_sample(n) < prob
    if not m.any():
        m[rs.randint(n)] = True
    return m


def _rs(state) -> np.random.RandomState:
    rs = np.random.RandomState()
    rs.set_state(state)
    return rs


def _slots(flags: np.ndarray, n_slots: int):
    pos = np.zeros((len(flags), n_slots), np.int32)
    valid = np.zeros((len(flags), n_slots), np.float32)
    for i, f in enumerate(flags):
        idx = np.nonzero(f)[0][:n_slots]
        pos[i, :len(idx)] = idx
        valid[i, :len(idx)] = 1.0
    return pos, valid


def pretrain_batch(task: str, tags: List[tuple], t_b: int, r_b: int,
                   texts: TextCorpus, images: ImageCorpus,
                   mask_prob: float) -> Dict[str, np.ndarray]:
    """``tags``: per row (text id, image name, target, random-stream state
    or None) as the harness's datasets recorded them."""
    cls_, sep = META["CLS"], META["SEP"]
    rows, labels, masks = [], [], []
    for tid, name, _target, state in tags:
        i = texts.index[tid]
        words = texts.tokens[i]
        if task == "mlm":
            tok, lab = random_word(words, _rs(state))
            rows.append((np.asarray([cls_] + tok + [sep], np.int32), name,
                         None))
            labels.append([-1] + lab + [-1])
        elif task in ("mrfr", "mrckl"):
            feat, _ = images.feat_pos(name)
            m = img_mask(mask_prob, len(feat), _rs(state))
            rows.append((texts.with_specials(i), name,
                         np.where(m[:, None], 0.0, feat).astype(np.float32)))
            masks.append(m)
        else:
            rows.append((texts.with_specials(i), name, None))
    out = joint_rows(rows, t_b, r_b, images)
    bs = len(tags)
    if task == "mlm":
        n_slots = max(1, math.ceil(0.24 * t_b) + 1)
        lab = np.full((bs, t_b), -1, np.int32)
        for r, x in enumerate(labels):
            lab[r, :min(len(x), t_b)] = x[:t_b]
        out["mlm_pos"], valid = _slots(lab != -1, n_slots)
        out["mlm_tgt"] = np.where(
            valid > 0, np.take_along_axis(lab, out["mlm_pos"], 1),
            -1).astype(np.int32)
    elif task in ("mrfr", "mrckl"):
        n_slots = max(1, math.ceil(0.3 * r_b) + 1)
        flags = np.zeros((bs, r_b), bool)
        for r, m in enumerate(masks):
            flags[r, :min(len(m), r_b)] = m[:r_b]
        out["img_masks"] = flags.astype(np.int64)
        out["mrm_pos"], out["mrm_valid"] = _slots(flags, n_slots)
        full = np.zeros((bs, r_b, 2048 if task == "mrfr" else 1601),
                        np.float32)
        for r, (_, name, _, _) in enumerate(tags):
            j = images.index[name]
            src = (images.record(j)["features"] if task == "mrfr"
                   else images.record(j)["soft_labels"]).astype(np.float32)
            full[r, :min(len(src), r_b)] = src[:r_b]
        key = "feat_targets" if task == "mrfr" else "label_targets"
        out[key] = np.take_along_axis(full, out["mrm_pos"][..., None], 1)
    else:
        out["targets"] = np.asarray([t for _, _, t, _ in tags], np.int32)
    return out
