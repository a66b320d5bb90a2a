"""VCR fine-tuning on one device (counterpart of the root ``train_vcr.py``,
reference train_vcr.py):

    python -m uniter_tpu_torch.train_vcr --config CONFIG.json \\
        [--device cuda] [--tasks qa,qar] ...

Same flags, DBs (a VCR txt DB with ``id2len_qa.json``/``id2len_qar.json``
and two img DBs, ground-truth and detected regions, concatenated per
example) and ``--config`` JSON as the root driver. The trunk has 4
token-type rows (question 0, image 1, answer 2, rationale 3) and 81
special word rows past the model config's vocabulary; ``--checkpoint``
fills them through the driver's surgeries (type rows 2 and 3 copied from
row 0, the new word rows left at init; a ``vcr_pretrain`` checkpoint that
has them loads as it is). ``--tasks qa,qar`` trains both tasks, one dataset
after the other (train_vcr.py:140-149). The loss is the mean cross-entropy
over the real candidate rows; the head (``vcr_output.*``) gets
``--lr_mul``. Validation reports ``qa_acc`` and ``qar_joint_acc``;
``python -m uniter_tpu_torch.inf_vcr --train_dir OUTPUT_DIR`` scores val or
writes the test submission. On the card the default flags run K1/K2 and the
fused tails K3-K6.
"""

from __future__ import annotations

import argparse

from uniter_tpu_torch.data.buckets import spec_from_dataset
from uniter_tpu_torch.data.datasets import ConcatDataset
from uniter_tpu_torch.data.loader import BucketLoader
from uniter_tpu_torch.data.vcr import VcrDataset, VcrEvalDataset
from uniter_tpu_torch.models.vcr import (
    NUM_SPECIAL_TOKENS, UniterForVisualCommonsenseReasoning)
from uniter_tpu_torch.training import driver, infer
from uniter_tpu_torch.utils.const import IMG_DIM
from uniter_tpu_torch.utils.logger import LOGGER
from uniter_tpu_torch.utils.misc import parse_with_config


def vcr_loss(model, batch, generator):
    """Mean cross-entropy over the candidate rows ``ex_weight`` marks real
    (reference model/vcr.py:72-75)."""
    per_row = model(batch, True, deterministic=False, generator=generator)
    w = batch["ex_weight"].float()
    return (per_row * w).sum() / w.sum().clamp_min(1.0)


def vcr_config(cfg):
    """``cfg`` with the 81 special words past its vocabulary. The run's
    ``model.json`` records the vocabulary without them, as the JAX driver
    writes it; ``inf_vcr`` adds them again."""
    return cfg.replace(vocab_size=cfg.vocab_size + NUM_SPECIAL_TOKENS)


def score_groups(batch, scores):
    """(example index, its 4 qa scores, its qar scores) of every example of
    an eval batch: its rows are consecutive, ``n_rows`` of them."""
    off = 0
    for i, n_rows in enumerate(batch["n_rows"]):
        yield i, scores[off:off + 4], scores[off + 4:off + n_rows]
        off += n_rows


def validate(model, loader, device):
    """qa accuracy and qa-then-qar joint accuracy (reference train_vcr.py
    validate)."""
    model.eval()
    n_qa, n_qar, n_ex = 0, 0, 0
    for batch, out in infer.eval_batches(
            lambda b: model(b, False), loader, device):
        scores = out.float().cpu().numpy()[:, 0]
        for i, qa, qar in score_groups(batch, scores):
            qa_ok = int(qa.argmax()) == int(batch["qa_targets"][i])
            qar_ok = (len(qar) > 0
                      and int(qar.argmax()) == int(batch["qar_targets"][i]))
            n_qa += int(qa_ok)
            n_qar += int(qa_ok and qar_ok)
            n_ex += 1
    model.train()
    return {"qa_acc": n_qa / max(n_ex, 1),
            "qar_joint_acc": n_qar / max(n_ex, 1), "n_ex": n_ex}


def build_model(opts, cfg):
    model = UniterForVisualCommonsenseReasoning(cfg, img_dim=IMG_DIM)
    driver.init_weights(model, cfg.initializer_range)
    driver.load_trunk_checkpoint(model, opts, n_type_rows=4, type_copy_row=0,
                                 n_special_words=NUM_SPECIAL_TOKENS)
    return model.to(opts.device)


def build_train_dataset(opts):
    from uniter_tpu_torch.data.vcr import VcrTxtTokDb

    img_db = driver.open_img_db(opts.train_img_db, opts)
    img_db_gt = driver.open_img_db(opts.train_img_db_gt, opts, gt=True)
    parts = [VcrDataset(VcrTxtTokDb(opts.train_txt_db,
                                    max_txt_len=opts.max_txt_len, task=task),
                        img_db_gt=img_db_gt, img_db=img_db)
             for task in opts.tasks.split(",")]
    return parts[0] if len(parts) == 1 else ConcatDataset(parts)


def main(opts):
    from uniter_tpu_torch.data.vcr import VcrTxtTokDb

    driver.check_unported(opts)
    cfg = driver.model_config_from_opts(opts, type_vocab_size=4)
    driver.setup_run(opts, cfg)
    model = build_model(opts, vcr_config(cfg))

    train_ds = build_train_dataset(opts)
    train_loader = BucketLoader(
        train_ds, driver.bucket_spec(opts, train_ds), seed=opts.seed,
        loop=True, collate=VcrDataset.collate, num_workers=opts.n_workers,
        worker_type=getattr(opts, "worker_type", None))
    val_ds = VcrEvalDataset(
        "val", VcrTxtTokDb(opts.val_txt_db, max_txt_len=-1, task="qa,qar"),
        img_db_gt=driver.open_img_db(opts.val_img_db_gt, opts, gt=True),
        img_db=driver.open_img_db(opts.val_img_db, opts))
    # the grid from the val dataset itself: its texts are not truncated
    val_loader = BucketLoader(
        val_ds, spec_from_dataset(val_ds, opts.val_batch_size),
        shuffle=False, drop_last=False, collate=val_ds.collate_fn)

    def validate_fn(state, step):
        logs = validate(state.model, val_loader, opts.device)
        LOGGER.info("step %d: qa %.4f qar-joint %.4f", step, logs["qa_acc"],
                    logs["qar_joint_acc"])
        return logs

    try:
        return driver.run_training(
            opts, model=model, train_loader=train_loader,
            loss_fn=lambda m, b, g: (vcr_loss(m, b, g), {}),
            validate_fn=validate_fn, lr_mul_paths=("vcr_",))
    finally:
        train_loader.close()


def get_parser():
    parser = argparse.ArgumentParser()
    driver.add_common_args(parser)
    parser.add_argument("--train_txt_db", type=str)
    parser.add_argument("--train_img_db", type=str)
    parser.add_argument("--train_img_db_gt", type=str)
    parser.add_argument("--val_txt_db", type=str)
    parser.add_argument("--val_img_db", type=str)
    parser.add_argument("--val_img_db_gt", type=str)
    parser.add_argument("--tasks", default="qa,qar",
                        help="comma-separated: qa,qar")
    parser.add_argument("--checkpoint_from", default="pretrain",
                        choices=["pretrain", "vcr_pretrain"],
                        help="either loads through the same surgeries: a "
                             "vcr_pretrain checkpoint already has the 4 "
                             "type rows and the 81 special words")
    parser.set_defaults(learning_rate=6e-5, lr_mul=10.0, max_txt_len=220,
                        num_train_steps=8000, warmup_steps=800,
                        train_batch_size=4000)
    return parser


if __name__ == "__main__":
    main(parse_with_config(get_parser()))
