"""VQA fine-tuning (counterpart of the root ``train_vqa.py``, reference
train_vqa.py), on one device or data-parallel over N:

    python -m uniter_tpu_torch.train_vqa --config CONFIG.json \\
        [--device cuda] [--num_train_steps N] ...
    torchrun --standalone --nproc_per_node N -m uniter_tpu_torch.train_vqa \\
        --config CONFIG.json [--fsdp] [--dist_backend gloo] ...

Same flags, txt/img DBs and ``--config`` JSON as the root driver. Loss =
BCE.mean() * num_answers over the rows ``ex_weight`` selects
(train_vqa.py:188); the answer head (``vqa_output.*``) gets a 10x lr
multiplier (train_vqa.py:208-214). Writes ``log/`` (hps.json, model.json,
scalars.jsonl, log.txt) and ``ckpt/`` (model_step_N.pt, train_state_N.pt,
ans2label.json) under ``--output_dir``; rerunning resumes from the latest
train state; ``python -m uniter_tpu_torch.inf_vqa --train_dir OUTPUT_DIR``
answers from it. Compute runs in ``--dtype`` (bf16) over fp32 parameters;
on the card the default flags run attention through K1/K2 and the dropout +
residual + LayerNorm tails through K3-K6.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from uniter_tpu_torch.data.loader import BucketLoader
from uniter_tpu_torch.data.vqa import VqaDataset
from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
from uniter_tpu_torch.parallel.collectives import global_sum, process_index
from uniter_tpu_torch.training import driver, infer
from uniter_tpu_torch.utils.const import IMG_DIM
from uniter_tpu_torch.utils.logger import LOGGER
from uniter_tpu_torch.utils.misc import parse_with_config


def vqa_loss(model, batch, generator, num_answer: int):
    """The reference loss, bce.mean() * num_answers (train_vqa.py:188), over
    the rows ``ex_weight`` marks real (the collate pads with weight 0) of
    the global batch: this rank's share (``global_sum``)."""
    per_elem = model(batch, True, deterministic=False, generator=generator)
    w = batch["ex_weight"].float()[:, None]
    return ((per_elem * w).sum()
            / (global_sum(w.sum()) * num_answer).clamp_min(1.0)) * num_answer


def validate(model, loader, num_answer, device):
    """VQA soft-score accuracy (reference train_vqa.py:312-341): each rank
    scores its share of the loader, the counts summed over the ranks."""
    model.eval()
    score_sum, n_ex = 0.0, 0
    for batch, out in infer.eval_batches(model.predict, loader, device):
        targets = np.asarray(batch["targets"])
        preds = out.float().cpu().numpy()[:len(targets)].argmax(-1)
        w = np.asarray(batch["ex_weight"]) > 0
        score_sum += float(targets[np.arange(len(preds)), preds][w].sum())
        n_ex += int(w.sum())
    model.train()
    score_sum, n_ex = infer.gather_sums(score_sum, n_ex)
    return {"score": score_sum / max(n_ex, 1), "n_ex": n_ex}


def build_model(opts, cfg):
    model = UniterForVisualQuestionAnswering(cfg, img_dim=IMG_DIM,
                                             num_answer=opts.num_answer)
    driver.init_weights(model, cfg.initializer_range)
    driver.load_trunk_checkpoint(model, opts)
    return model.to(opts.device)


def main(opts):
    from uniter_tpu_torch.data.txt_db import TxtTokDb
    from uniter_tpu_torch.utils.vqa_answers import load_ans2label

    ans2label = None
    if getattr(opts, "ans2label", None):
        ans2label = load_ans2label(opts.ans2label)
        opts.num_answer = len(ans2label)
    elif opts.num_answer == 3129:
        try:
            ans2label = load_ans2label(None)
            opts.num_answer = len(ans2label)
        except FileNotFoundError:
            pass
    cfg = driver.model_config_from_opts(opts)
    driver.setup_run(opts, cfg)
    if ans2label is not None and process_index() == 0:
        with open(os.path.join(opts.output_dir, "ckpt", "ans2label.json"),
                  "w") as f:
            json.dump(ans2label, f)
    model = build_model(opts, cfg)

    txt_db = TxtTokDb(opts.train_txt_db, max_txt_len=opts.max_txt_len)
    img_db = driver.open_img_db(opts.train_img_db, opts)
    train_ds = VqaDataset(opts.num_answer, txt_db, img_db)
    train_loader = BucketLoader(
        train_ds, driver.bucket_spec(opts, train_ds), seed=opts.seed,
        loop=True, num_workers=opts.n_workers,
        worker_type=getattr(opts, "worker_type", None),
        **driver.shard_kw())
    val_txt = TxtTokDb(opts.val_txt_db, max_txt_len=opts.max_txt_len)
    val_img = driver.open_img_db(opts.val_img_db, opts)
    val_loader = BucketLoader(
        VqaDataset(opts.num_answer, val_txt, val_img),
        driver.bucket_spec(opts, train_ds, opts.val_batch_size),
        shuffle=False, drop_last=False, **driver.shard_kw())
    num_answer = opts.num_answer

    def loss_fn(m, batch, generator):
        return vqa_loss(m, batch, generator, num_answer), {}

    def validate_fn(state, step):
        logs = validate(state.model, val_loader, num_answer, opts.device)
        LOGGER.info("step %d: val score %.4f", step, logs["score"])
        return logs

    try:
        return driver.run_training(
            opts, model=model, loss_fn=loss_fn, train_loader=train_loader,
            validate_fn=validate_fn, lr_mul_paths=("vqa_",))
    finally:
        train_loader.close()


def get_parser():
    parser = argparse.ArgumentParser()
    driver.add_common_args(parser)
    parser.add_argument("--train_txt_db", type=str)
    parser.add_argument("--train_img_db", type=str)
    parser.add_argument("--val_txt_db", type=str)
    parser.add_argument("--val_img_db", type=str)
    parser.add_argument("--num_answer", type=int, default=3129,
                        help="overridden by the --ans2label vocabulary size")
    parser.add_argument("--ans2label", default=None,
                        help="answer->label json (default: the in-tree "
                             "uniter_tpu/utils/ans2label.json)")
    parser.set_defaults(learning_rate=8e-5, lr_mul=10.0, max_txt_len=60,
                        num_train_steps=6000, warmup_steps=600)
    return parser


if __name__ == "__main__":
    main(parse_with_config(get_parser()))
