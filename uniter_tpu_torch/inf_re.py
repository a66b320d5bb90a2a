"""Referring-expression inference on one device (counterpart of the root
``inf_re.py``, reference inf_re.py): IoU > 0.5 accuracy of the top-scoring
box over gt or detected regions, and the per-sentence predictions:

    python -m uniter_tpu_torch.inf_re --txt_db VAL.db[:TESTA.db:...] \\
        --img_db DB --train_dir RUN --output_dir OUT [--ckpt best] \\
        [--use_gt_feat] [--device cuda]

Reads a training directory of this package or of the JAX package. Writes
``results_{gt|det}.json`` for one split, ``results_{split}_{gt|det}.json``
for each of several colon-separated splits, each ``{"acc", "n_ex",
"predictions": [{"sent_id", "pred_box", "iou"}]}``, and returns the
accuracy over all of them. Inference runs fp32 with dropout off (K1 on the
card); TF32 stays off.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from uniter_tpu_torch.data.buckets import spec_from_dataset
from uniter_tpu_torch.data.loader import BucketLoader
from uniter_tpu_torch.data.re import ReEvalDataset, compute_iou
from uniter_tpu_torch.models.re import UniterForReferringExpressionComprehension
from uniter_tpu_torch.train_re import predicted_boxes
from uniter_tpu_torch.training import infer
from uniter_tpu_torch.training.driver import open_img_db
from uniter_tpu_torch.utils.const import IMG_DIM
from uniter_tpu_torch.utils.logger import LOGGER


def split_names(paths):
    """Result-file names of the splits: the DB's basename without
    ``.db``, indexed when two basenames collide."""
    def name(p):
        base = os.path.basename(os.path.normpath(p))
        return base[:-3] if base.endswith(".db") else base

    names = [name(p) for p in paths]
    if len(set(names)) != len(names):
        names = [f"{n}{i}" for i, n in enumerate(names)]
    return names


def evaluate_split(model, loader, device):
    """(n_correct, n_ex, predictions) over one split."""
    n_correct, n_ex, predictions = 0, 0, []
    for batch, out in infer.eval_batches(model.predict, loader, device):
        scores = out.float().cpu().numpy()
        for i, box in predicted_boxes(batch, scores):
            iou = compute_iou(box, batch["tgt_box"][i])
            n_correct += int(iou > 0.5)
            n_ex += 1
            predictions.append({"sent_id": batch["sent_ids"][i],
                                "pred_box": [float(x) for x in box],
                                "iou": float(iou)})
    return n_correct, n_ex, predictions


def main(opts):
    from uniter_tpu_torch.data.re import ReTxtTokDb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(opts.device)
    hps, model_json = infer.load_train_meta(opts.train_dir)
    cfg = infer.model_config_from_meta(
        model_json, device, dtype="float32",
        attention_impl=getattr(hps, "attention_impl", "xla"))
    model = UniterForReferringExpressionComprehension(
        cfg, img_dim=IMG_DIM, loss_type=getattr(hps, "train_loss", "cls"),
        mlp=getattr(hps, "mlp", 1))
    model.load_state_dict(
        infer.load_params(infer.resolve_ckpt(opts.train_dir, opts.ckpt)),
        strict=True)
    model.to(device).eval()
    img_db = open_img_db(opts.img_db, hps, gt="coco_gt" in opts.img_db)

    splits = [p for p in opts.txt_db.split(":") if p]
    feat = "gt" if opts.use_gt_feat else "det"
    tot_correct, tot_ex = 0, 0
    os.makedirs(opts.output_dir, exist_ok=True)
    for txt_path, sname in zip(splits, split_names(splits)):
        ds = ReEvalDataset(ReTxtTokDb(txt_path, max_txt_len=-1), img_db,
                           use_gt_feat=opts.use_gt_feat)
        loader = BucketLoader(ds, spec_from_dataset(ds, opts.batch_size),
                              shuffle=False, drop_last=False)
        n_correct, n_ex, predictions = evaluate_split(model, loader, device)
        acc = n_correct / max(n_ex, 1)
        tot_correct += n_correct
        tot_ex += n_ex
        name = (f"results_{feat}.json" if len(splits) == 1
                else f"results_{sname}_{feat}.json")
        with open(os.path.join(opts.output_dir, name), "w") as f:
            json.dump({"acc": acc, "n_ex": n_ex,
                       "predictions": predictions}, f)
        LOGGER.info("RE %s %s-feature accuracy: %.4f (%d ex)", sname, feat,
                    acc, n_ex)
    return tot_correct / max(tot_ex, 1)


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--txt_db", required=True,
                        help="colon-separated split DBs, e.g. "
                             "refcoco_val.db:refcoco_testA.db:"
                             "refcoco_testB.db (reference inf_re.py:76)")
    parser.add_argument("--img_db", required=True)
    parser.add_argument("--train_dir", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--use_gt_feat", action="store_true")
    parser.add_argument("--batch_size", type=int, default=8192)
    parser.add_argument("--device", default="cuda")
    return parser


if __name__ == "__main__":
    main(get_parser().parse_args())
