"""Image-text retrieval fine-tuning on one device (counterpart of the root
``train_itm.py``, reference train_itm.py):

    python -m uniter_tpu_torch.train_itm --config CONFIG.json \\
        [--device cuda] [--num_train_steps N] ...

Same flags, txt/img DBs, ``--config`` JSON and recipe defaults as the root
driver (reference config/train-itm-flickr-base-*.json). ``ItmRankDataset``
groups (1 pos + 2 * negative_size) pairs per example; the loss is the
margin triplet over sigmoid rank scores (model/itm.py:45-53), a plain mean
over every real group's terms (train_itm.py:164-165). ``--checkpoint``
loads the trunk and seeds ``rank_output`` from the ITM head's match row.
Validation ranks each text's ground-truth image in its window of
``inf_minibatch_size`` images (``ItmValDataset``), through the device-
resident scorer (``utils/itm_fast.py``) on the card and the per-text
minibatches on the CPU. Writes ``log/`` and ``ckpt/`` under
``--output_dir`` as ``train_vqa`` does; rerunning resumes;
``python -m uniter_tpu_torch.inf_itm --train_dir OUTPUT_DIR`` scores from
it. On the card the default flags run K1/K2 and the fused tails K3-K6; a
model config with ``"ffn_impl": "pallas"`` or ``"cuda"`` adds K9.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from uniter_tpu_torch.data.itm import (
    ItmEvalDataset, ItmRankDataset, ItmValDataset)
from uniter_tpu_torch.data.loader import BucketLoader
from uniter_tpu_torch.models.itm import (
    UniterForImageTextRetrieval, seed_rank_head)
from uniter_tpu_torch.training import driver
from uniter_tpu_torch.utils.const import IMG_DIM
from uniter_tpu_torch.utils.itm_eval import inference_score_matrix, itm_eval
from uniter_tpu_torch.utils.logger import LOGGER
from uniter_tpu_torch.utils.misc import parse_with_config


def build_model(opts, cfg, cls=UniterForImageTextRetrieval, **kw):
    model = cls(cfg, img_dim=IMG_DIM, margin=opts.margin, **kw)
    driver.init_weights(model, cfg.initializer_range)
    driver.load_trunk_checkpoint(model, opts, extra=seed_rank_head)
    return model.to(opts.device)


def rank_loss(model, batch, generator, sample_size: int):
    """Mean over the [G, sample_size - 1] triplet terms of the groups whose
    positive row is real (``ex_weight``), no per-group rescale
    (train_itm.py:164-172)."""
    per_group = model(batch, True, sample_size=sample_size,
                      deterministic=False, generator=generator)
    w = batch["ex_weight"].float().reshape(-1, sample_size)[:, :1]
    return ((per_group * w).sum()
            / (w.sum() * (sample_size - 1)).clamp_min(1.0))


def _window_recall_logs(ranks):
    """Windowed-recall counters -> the reference's validation scalars
    (train_itm_hard_negatives.py:298-339)."""
    n = max(len(ranks), 1)
    ranks = np.asarray(ranks)
    logs = {"recall_1": float((ranks < 1).sum()) / n,
            "recall_5": float((ranks < 5).sum()) / n,
            "recall_10": float((ranks < 10).sum()) / n}
    logs["r_mean"] = (logs["recall_1"] + logs["recall_5"]
                      + logs["recall_10"]) / 3
    return logs


def validate_retrieval(model, val_ds, impl="auto"):
    """Full-matrix R@K for an ``ItmEvalDataset``; for an ``ItmValDataset``
    the rank of the ground-truth image (window index 0) among its window's
    scores (train_itm_hard_negatives.py:268-310).

    ``impl``: "fast" scores device-resident tiles (``utils/itm_fast.py``),
    "batched" the per-text minibatches, "auto" fast on a CUDA device and
    batched on the CPU. The model is left in train mode."""
    from uniter_tpu_torch.utils.itm_fast import (
        fast_score_matrix, fast_windowed_scores)

    t_bucket, r_bucket = val_ds.bucket_hint()
    device = next(model.parameters()).device
    if impl == "auto":
        impl = "fast" if device.type == "cuda" else "batched"
    dtype = model.uniter.config.dtype
    model.eval()
    try:
        if isinstance(val_ds, ItmEvalDataset):
            if impl == "fast":
                mat, txt_ids = fast_score_matrix(
                    model, val_ds, t_bucket, r_bucket, dtype=dtype)
            else:
                mat, txt_ids = inference_score_matrix(
                    model.predict, val_ds, t_bucket, r_bucket, device)
            return itm_eval(mat, txt_ids, val_ds.all_img_ids,
                            val_ds.txt2img, val_ds.img2txts)
        if impl == "fast":
            rows, _ = fast_windowed_scores(model, val_ds, t_bucket, r_bucket,
                                           dtype=dtype)
        else:
            rows, _ = inference_score_matrix(model.predict, val_ds, t_bucket,
                                             r_bucket, device)
        # gt at window index 0
        return _window_recall_logs(
            [int(np.argsort(-s).tolist().index(0)) for s in rows])
    finally:
        model.train()


def build_rank_dataset(opts, sample_size):
    from uniter_tpu_torch.data.datasets import ConcatDataset
    from uniter_tpu_torch.data.txt_db import TxtTokDb

    # reference configs declare db LISTS (train_txt_dbs/train_img_dbs,
    # e.g. COCO train + restval); singular flags remain for one corpus
    txt_paths = opts.train_txt_dbs or [opts.train_txt_db]
    img_paths = opts.train_img_dbs or [opts.train_img_db]
    parts = []
    for txt_path, img_path in zip(txt_paths, img_paths):
        ds = ItmRankDataset(TxtTokDb(txt_path, max_txt_len=opts.max_txt_len),
                            driver.open_img_db(img_path, opts),
                            neg_sample_size=opts.negative_size)
        ds.rows_per_example = sample_size
        parts.append(ds)
    return parts[0] if len(parts) == 1 else ConcatDataset(parts)


def build_val_dataset(opts):
    from uniter_tpu_torch.data.txt_db import TxtTokDb

    return ItmValDataset(
        TxtTokDb(opts.val_txt_db, max_txt_len=opts.max_txt_len),
        driver.open_img_db(opts.val_img_db, opts),
        mini_batch_size=opts.inf_minibatch_size)


def main(opts):
    driver.check_unported(opts)
    cfg = driver.model_config_from_opts(opts)
    driver.setup_run(opts, cfg)
    model = build_model(opts, cfg)
    sample_size = 1 + 2 * opts.negative_size
    train_ds = build_rank_dataset(opts, sample_size)
    train_loader = BucketLoader(
        train_ds, driver.bucket_spec(opts, train_ds), ItmRankDataset.collate,
        seed=opts.seed, loop=True, num_workers=opts.n_workers,
        worker_type=getattr(opts, "worker_type", None))
    val_ds = build_val_dataset(opts)

    def validate_fn(state, step):
        logs = validate_retrieval(state.model, val_ds)
        LOGGER.info("step %d: r_mean %.4f", step, logs["r_mean"])
        return logs

    try:
        return driver.run_training(
            opts, model=model, train_loader=train_loader,
            loss_fn=lambda m, b, g: (rank_loss(m, b, g, sample_size), {}),
            validate_fn=validate_fn)
    finally:
        train_loader.close()


def get_parser():
    parser = argparse.ArgumentParser()
    driver.add_common_args(parser)
    parser.add_argument("--train_txt_db", type=str)
    parser.add_argument("--train_img_db", type=str)
    parser.add_argument("--train_txt_dbs", type=str, nargs="*", default=None)
    parser.add_argument("--train_img_dbs", type=str, nargs="*", default=None)
    parser.add_argument("--val_txt_db", type=str)
    parser.add_argument("--val_img_db", type=str)
    parser.add_argument("--negative_size", type=int, default=1)
    parser.add_argument("--margin", type=float, default=0.2)
    parser.add_argument("--inf_minibatch_size", type=int, default=400)
    parser.set_defaults(learning_rate=5e-5, num_train_steps=5000,
                        warmup_steps=500, train_batch_size=8192)
    return parser


if __name__ == "__main__":
    main(parse_with_config(get_parser()))
