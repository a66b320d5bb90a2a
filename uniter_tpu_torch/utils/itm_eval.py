"""Image-text retrieval evaluation (counterpart of
``uniter_tpu/utils/itm_eval.py``, reference utils/itm_eval.py).

``itm_eval``: R@1/5/10 in both directions and their means from the full
score matrix (reference :19-66), the JAX module's numpy code.
``inference_score_matrix`` builds the [n_txt, n_img] score matrix one text
at a time over the eval dataset's minibatches (reference :93-114); over
several processes each rank scores a stride of the texts and the rows are
gathered (``utils.itm_fast.gather_rows``).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch


def itm_eval(score_matrix: np.ndarray, txt_ids: List[str],
             img_ids: List[str], txt2img: Dict[str, str],
             img2txts: Dict[str, List[str]]) -> Dict[str, float]:
    # image retrieval (text query -> rank of gt image)
    img2j = {i: j for j, i in enumerate(img_ids)}
    gt_img_j = np.asarray([img2j[txt2img[t]] for t in txt_ids])
    order = np.argsort(-score_matrix, axis=1)  # descending
    rank = np.argmax(order == gt_img_j[:, None], axis=1)
    ir_r1 = float((rank < 1).mean())
    ir_r5 = float((rank < 5).mean())
    ir_r10 = float((rank < 10).mean())

    # text retrieval (image query -> best rank over its gt texts)
    txt2i = {t: i for i, t in enumerate(txt_ids)}
    tr_ranks = []
    for j, img in enumerate(img_ids):
        gt_is = [txt2i[t] for t in img2txts[img] if t in txt2i]
        if not gt_is:
            continue
        col_order = np.argsort(-score_matrix[:, j])
        pos = np.isin(col_order, gt_is).nonzero()[0]
        tr_ranks.append(pos.min() if len(pos) else len(txt_ids))
    tr_ranks = np.asarray(tr_ranks)
    tr_r1 = float((tr_ranks < 1).mean())
    tr_r5 = float((tr_ranks < 5).mean())
    tr_r10 = float((tr_ranks < 10).mean())

    tr_mean = (tr_r1 + tr_r5 + tr_r10) / 3
    ir_mean = (ir_r1 + ir_r5 + ir_r10) / 3
    r_mean = (tr_mean + ir_mean) / 2
    return {
        "txt_r1": tr_r1, "txt_r5": tr_r5, "txt_r10": tr_r10,
        "txt_r_mean": tr_mean,
        "img_r1": ir_r1, "img_r5": ir_r5, "img_r10": ir_r10,
        "img_r_mean": ir_mean,
        "r_mean": r_mean,
    }


def inference_score_matrix(predict_fn: Callable, eval_dataset, t_bucket,
                           r_bucket, device):
    """Score-matrix rows [n_txt, n_img] and the text ids.

    ``predict_fn(batch)`` maps a batch of device tensors to [B, 1] rank
    scores (the model on ``device`` already). Each window's padding rows
    (``ex_weight`` 0) are trimmed. Each rank scores ``my_rows`` of the
    texts; every rank gets the whole matrix."""
    from uniter_tpu_torch.training.infer import to_device
    from uniter_tpu_torch.utils.itm_fast import gather_rows, my_rows

    device = torch.device(device)
    rows = []
    for i in my_rows(len(eval_dataset)):
        scores = []
        for batch in eval_dataset.get_batches(i, t_bucket, r_bucket):
            n_real = (int(batch["ex_weight"].sum()) if "ex_weight" in batch
                      else batch["input_ids"].shape[0])
            with torch.inference_mode():
                out = predict_fn(to_device(batch, device))
            scores.append(out[:n_real, 0].float().cpu().numpy())
        rows.append(np.concatenate(scores))
    if rows:
        mine = np.stack(rows)
    else:  # no text here (fewer than ranks): an empty block of the width
        from uniter_tpu_torch.data.itm import ItmEvalDataset

        width = (len(eval_dataset.all_img_ids)
                 if isinstance(eval_dataset, ItmEvalDataset)
                 else eval_dataset.bs)
        mine = np.zeros((0, width), np.float32)
    return gather_rows(mine, len(eval_dataset)), list(eval_dataset.ids)
