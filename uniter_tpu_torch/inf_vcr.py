"""VCR inference on one device (counterpart of the root ``inf_vcr.py``,
reference inf_vcr.py):

    python -m uniter_tpu_torch.inf_vcr --txt_db DB --img_db DB \\
        --img_db_gt DB --train_dir RUN --output_dir OUT \\
        [--split val|test] [--ckpt best|N|FILE] [--device cuda]

Reads a training directory of this package or of the JAX package; the
model gets 4 type rows and ``model.json``'s vocabulary + 81 special words.
``val`` scores the 4 answers and the 4 rationales given the gold answer and
writes ``results_val.json`` (``qa_acc``, ``qar_joint_acc``, ``n_ex``);
``test`` scores the 4 answers and all 16 answer-conditioned rationales and
writes the leaderboard's ``test_submission.csv``: per question the softmax
of its 4 answer scores, then of each answer's 4 rationale scores
(inf_vcr.py:56-84). Inference runs fp32 with dropout off (K1 on the card);
TF32 stays off.
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np
import torch

from uniter_tpu_torch.data.buckets import spec_from_dataset
from uniter_tpu_torch.data.loader import BucketLoader
from uniter_tpu_torch.data.vcr import VcrEvalDataset
from uniter_tpu_torch.models.vcr import UniterForVisualCommonsenseReasoning
from uniter_tpu_torch.train_vcr import score_groups, vcr_config
from uniter_tpu_torch.training import infer
from uniter_tpu_torch.training.driver import open_img_db
from uniter_tpu_torch.utils.const import IMG_DIM
from uniter_tpu_torch.utils.logger import LOGGER

HEADER = (["annot_id"] + [f"answer_{i}" for i in range(4)]
          + [f"rationale_conditioned_on_a{g}_{i}"
             for g in range(4) for i in range(4)])


def softmax2(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def score_examples(model, loader, device, split):
    """(logs, submission rows) over the loader: on ``val`` the qa and
    joint accuracy, on ``test`` one row per question."""
    n_qa, n_qar, n_ex = 0, 0, 0
    rows_out = []
    for batch, out in infer.eval_batches(
            lambda b: model(b, False), loader, device):
        scores = out.float().cpu().numpy()[:, 0]
        for i, qa, qar in score_groups(batch, scores):
            if split == "val":
                qa_ok = int(qa.argmax()) == int(batch["qa_targets"][i])
                qar_ok = (len(qar) == 4 and int(qar.argmax())
                          == int(batch["qar_targets"][i]))
                n_qa += int(qa_ok)
                n_qar += int(qa_ok and qar_ok)
            else:
                row = [batch["qids"][i]] + list(softmax2(qa))
                for g in range(4):
                    grp = qar[g * 4:(g + 1) * 4]
                    row += (list(softmax2(grp)) if len(grp) == 4
                            else [0.25] * 4)
                rows_out.append(row)
            n_ex += 1
    logs = {"qa_acc": n_qa / max(n_ex, 1),
            "qar_joint_acc": n_qar / max(n_ex, 1), "n_ex": n_ex}
    return logs, rows_out


def main(opts):
    from uniter_tpu_torch.data.vcr import VcrTxtTokDb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(opts.device)
    hps, model_json = infer.load_train_meta(opts.train_dir)
    cfg = vcr_config(infer.model_config_from_meta(
        model_json, device, type_vocab_size=4, dtype="float32",
        attention_impl=getattr(hps, "attention_impl", "xla")))
    model = UniterForVisualCommonsenseReasoning(cfg, img_dim=IMG_DIM)
    model.load_state_dict(
        infer.load_params(infer.resolve_ckpt(opts.train_dir, opts.ckpt)),
        strict=True)
    model.to(device).eval()

    ds = VcrEvalDataset(
        opts.split, VcrTxtTokDb(opts.txt_db, max_txt_len=-1, task="qa,qar"),
        img_db_gt=open_img_db(opts.img_db_gt, hps, gt=True),
        img_db=open_img_db(opts.img_db, hps))
    loader = BucketLoader(ds, spec_from_dataset(ds, opts.batch_size),
                          shuffle=False, drop_last=False,
                          collate=ds.collate_fn)
    logs, rows_out = score_examples(model, loader, device, opts.split)
    os.makedirs(opts.output_dir, exist_ok=True)
    if opts.split == "val":
        LOGGER.info("VCR val: %s", logs)
        with open(os.path.join(opts.output_dir, "results_val.json"),
                  "w") as f:
            json.dump(logs, f)
        return logs
    out_csv = os.path.join(opts.output_dir, f"{opts.split}_submission.csv")
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(HEADER)
        w.writerows(rows_out)
    LOGGER.info("wrote %d rows to %s", len(rows_out), out_csv)
    return out_csv


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--txt_db", required=True)
    parser.add_argument("--img_db", required=True)
    parser.add_argument("--img_db_gt", required=True)
    parser.add_argument("--train_dir", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--split", default="val", choices=["val", "test"])
    parser.add_argument("--batch_size", type=int, default=8192)
    parser.add_argument("--device", default="cuda")
    return parser


if __name__ == "__main__":
    main(get_parser().parse_args())
