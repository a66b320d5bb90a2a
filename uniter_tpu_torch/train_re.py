"""Referring-expression fine-tuning on one device (counterpart of the root
``train_re.py``, reference train_re.py):

    python -m uniter_tpu_torch.train_re --config CONFIG.json \\
        [--device cuda] [--train_loss cls|rank] [--mlp 1|2] ...

Same flags, DBs (``ReTxtTokDb``: refs / annotations / categories / images
JSON beside the text records; an img DB of ``visual_grounding_coco_gt``
features) and ``--config`` JSON as the root driver. The refs are shuffled
per epoch (re.py:65-68); the loss is summed over examples
(train_re.py:195) with ``loss_scale="mean"``; the head (``re_output.*``)
gets ``--lr_mul`` (train_re.py:65-101). Validation is IoU > 0.5 accuracy of
the top-scoring gt box; the best accuracy's weights are kept as
``ckpt/model_step_best.pt`` (train_re.py:259-263), which ``python -m
uniter_tpu_torch.inf_re --ckpt best`` loads. On the card the default flags
run K1/K2 and the fused tails K3-K6; the rank loss samples its negatives
on the card.
"""

from __future__ import annotations

import argparse

import numpy as np

from uniter_tpu_torch.data.buckets import spec_from_dataset
from uniter_tpu_torch.data.loader import BucketLoader
from uniter_tpu_torch.data.re import ReDataset, ReEvalDataset, compute_iou
from uniter_tpu_torch.models.re import UniterForReferringExpressionComprehension
from uniter_tpu_torch.training import driver, infer
from uniter_tpu_torch.utils.const import IMG_DIM
from uniter_tpu_torch.utils.logger import LOGGER
from uniter_tpu_torch.utils.misc import parse_with_config


def re_loss(model, batch, generator):
    """The per-example loss summed over the rows ``ex_weight`` marks real
    (reference train_re.py:195)."""
    per_ex = model(batch, True, deterministic=False, generator=generator)
    return (per_ex * batch["ex_weight"].float()).sum()


def predicted_boxes(batch, scores):
    """(row, predicted xywh box) of every real row: the box of the
    top-scoring region (reference inf_re.py:118-157)."""
    preds = scores.argmax(-1)
    w = np.asarray(batch["ex_weight"]) > 0
    for i in np.nonzero(w)[0]:
        obj_boxes = batch["obj_boxes"][i]
        yield i, obj_boxes[min(int(preds[i]), len(obj_boxes) - 1)]


def evaluate(model, loader, device):
    """IoU > 0.5 accuracy of the predicted box over the real rows."""
    model.eval()
    n_correct, n_ex = 0, 0
    for batch, out in infer.eval_batches(model.predict, loader, device):
        scores = out.float().cpu().numpy()
        for i, box in predicted_boxes(batch, scores):
            n_correct += int(compute_iou(box, batch["tgt_box"][i]) > 0.5)
            n_ex += 1
    model.train()
    return {"acc": n_correct / max(n_ex, 1), "n_ex": n_ex}


def build_model(opts, cfg):
    model = UniterForReferringExpressionComprehension(
        cfg, img_dim=IMG_DIM, loss_type=opts.train_loss, margin=opts.margin,
        hard_ratio=opts.hard_ratio, mlp=opts.mlp)
    driver.init_weights(model, cfg.initializer_range)
    driver.load_trunk_checkpoint(model, opts)
    return model.to(opts.device)


def main(opts):
    from uniter_tpu_torch.data.re import ReTxtTokDb

    driver.check_unported(opts)
    cfg = driver.model_config_from_opts(opts)
    driver.setup_run(opts, cfg)
    model = build_model(opts, cfg)

    txt_db = ReTxtTokDb(opts.train_txt_db, max_txt_len=opts.max_txt_len)
    img_db = driver.open_img_db(opts.train_img_db, opts)
    train_ds = ReDataset(txt_db, img_db)
    train_loader = BucketLoader(
        train_ds, driver.bucket_spec(opts, train_ds), seed=opts.seed,
        loop=True, num_workers=opts.n_workers,
        worker_type=getattr(opts, "worker_type", None))
    val_txt = ReTxtTokDb(opts.val_txt_db, max_txt_len=-1)
    val_img = driver.open_img_db(opts.val_img_db, opts)
    val_ds = ReEvalDataset(val_txt, val_img, use_gt_feat=True)
    # the grid from the val dataset itself: its texts are not truncated
    val_loader = BucketLoader(
        val_ds, spec_from_dataset(val_ds, opts.val_batch_size),
        shuffle=False, drop_last=False)

    def validate_fn(state, step):
        logs = evaluate(state.model, val_loader, opts.device)
        LOGGER.info("step %d: val IoU acc %.4f", step, logs["acc"])
        return logs

    try:
        return driver.run_training(
            opts, model=model, train_loader=train_loader,
            loss_fn=lambda m, b, g: (re_loss(m, b, g), {}),
            validate_fn=validate_fn, lr_mul_paths=("re_",),
            loss_scale="mean", best_metric="acc")
    finally:
        train_loader.close()


def get_parser():
    parser = argparse.ArgumentParser()
    driver.add_common_args(parser)
    parser.add_argument("--train_txt_db", type=str)
    parser.add_argument("--train_img_db", type=str)
    parser.add_argument("--val_txt_db", type=str)
    parser.add_argument("--val_img_db", type=str)
    parser.add_argument("--train_loss", default="cls",
                        choices=["cls", "rank"])
    parser.add_argument("--margin", type=float, default=0.2)
    parser.add_argument("--hard_ratio", type=float, default=0.3)
    parser.add_argument("--mlp", type=int, default=1)
    parser.set_defaults(learning_rate=1e-4, lr_mul=10.0, max_txt_len=60,
                        num_train_steps=24000, warmup_steps=2400,
                        train_batch_size=8192)
    return parser


if __name__ == "__main__":
    main(parse_with_config(get_parser()))
