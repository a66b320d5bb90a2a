"""VCR second-stage pretraining (counterpart of the root
``pretrain_vcr.py``, reference pretrain_vcr.py):

    python -m uniter_tpu_torch.pretrain_vcr --config CONFIG.json \\
        [--device cuda] [--num_train_steps N] ...

Same flags and ``--config`` JSON as the root driver: ``train_datasets`` /
``val_datasets`` name VCR txt DBs (``vcr_task`` qa, qar or qa,qar) and the
tasks to mix over them (mlm, mrfr, mrc, mrc-kl or its spelling ``mrckl``;
no ITM); the features are ``--train_img_db_gt`` and ``--train_img_db``
concatenated per example. The trunk has 4 token-type rows and 81 special
words past the model config's vocabulary, filled from ``--checkpoint`` by
the driver's surgeries, with the pretraining heads the file holds. The
tasks are mixed by the seeded ``MetaLoader`` under the pretraining loop
(``MixedTaskLoop``): per-task losses, validation and checkpoints at
``valid_steps``, and a rerun resumes with the task mix fast-forwarded. On
the card the default flags run K1/K2 and the fused tails K3-K6.

Data-parallel over N processes (``training/driver.py``):

    torchrun --standalone --nproc_per_node N -m uniter_tpu_torch.pretrain_vcr ...
"""

from __future__ import annotations

import argparse

from uniter_tpu_torch.data.loader import BucketLoader
from uniter_tpu_torch.data.pretrain_vcr import (
    MlmDatasetForVCR, MrcDatasetForVCR, MrfrDatasetForVCR)
from uniter_tpu_torch.models.pretrain_vcr import UniterForPretrainingForVCR
from uniter_tpu_torch.models.vcr import NUM_SPECIAL_TOKENS
from uniter_tpu_torch.pretrain import load_pretrain_heads, validate
from uniter_tpu_torch.training import driver
from uniter_tpu_torch.utils.const import IMG_DIM, IMG_LABEL_DIM
from uniter_tpu_torch.utils.misc import parse_with_config

DATASETS = {
    "mlm": lambda opts, *a, **kw: MlmDatasetForVCR(*a, **kw),
    "mrfr": lambda opts, *a, **kw: MrfrDatasetForVCR(opts.mrm_prob, *a, **kw),
    "mrc": lambda opts, *a, **kw: MrcDatasetForVCR(opts.mrm_prob, *a, **kw),
    "mrc-kl": lambda opts, *a, **kw: MrcDatasetForVCR(
        opts.mrm_prob, *a, **kw),
    # the reference configs spell it "mrckl" (config/pretrain-vcr-*.json)
    "mrckl": lambda opts, *a, **kw: MrcDatasetForVCR(
        opts.mrm_prob, *a, **kw),
}


def build_model(opts, cfg):
    model = UniterForPretrainingForVCR(cfg, img_dim=IMG_DIM,
                                       img_label_dim=IMG_LABEL_DIM)
    driver.init_weights(model, cfg.initializer_range)
    driver.load_trunk_checkpoint(
        model, opts, n_type_rows=4, type_copy_row=0,
        n_special_words=NUM_SPECIAL_TOKENS, extra=load_pretrain_heads)
    return model.to(opts.device)


def create_dataloaders(datasets_cfg, opts, img_db_gt, img_db, train=True):
    """name -> (loader, ratio); name is '{task}_{corpus-name}'."""
    from uniter_tpu_torch.data.vcr import VcrTxtTokDb

    out = {}
    for dset in datasets_cfg:
        for task, ratio in zip(dset["tasks"], dset.get(
                "mix_ratio", [1] * len(dset["tasks"]))):
            txt_db = VcrTxtTokDb(dset["db"], max_txt_len=opts.max_txt_len,
                                 task=dset.get("vcr_task", "qa,qar"))
            ds = DATASETS[task](opts, txt_db, img_db_gt=img_db_gt,
                                img_db=img_db)
            spec = driver.bucket_spec(
                opts, ds, budget=None if train else opts.val_batch_size)
            out[f"{task}_{dset['name']}"] = (
                BucketLoader(ds, spec, collate=type(ds).collate,
                             seed=opts.seed, loop=train, shuffle=train,
                             drop_last=train, num_workers=opts.n_workers,
                             worker_type=getattr(opts, "worker_type", None),
                             **driver.shard_kw()),
                ratio)
    return out


def main(opts):
    cfg = driver.model_config_from_opts(opts, type_vocab_size=4)
    driver.setup_run(opts, cfg)
    cfg = cfg.replace(vocab_size=cfg.vocab_size + NUM_SPECIAL_TOKENS)
    model = build_model(opts, cfg)

    img_db = driver.open_img_db(opts.train_img_db, opts)
    img_db_gt = driver.open_img_db(opts.train_img_db_gt, opts, gt=True)
    loaders = create_dataloaders(opts.train_datasets, opts, img_db_gt, img_db)
    val_loaders = {}
    if opts.val_datasets:
        raw = create_dataloaders(opts.val_datasets, opts, img_db_gt, img_db,
                                 train=False)
        val_loaders = {name: loader for name, (loader, _r) in raw.items()}

    def loss_fn(m, batch, generator, task):
        return m.scalar_loss(batch, task, deterministic=False,
                             generator=generator)

    return driver.run_pretraining(opts, model=model, loaders=loaders,
                                  val_loaders=val_loaders, validate=validate,
                                  loss_fn=loss_fn)


def get_parser():
    parser = argparse.ArgumentParser()
    driver.add_common_args(parser)
    parser.add_argument("--train_txt_db", type=str)
    parser.add_argument("--train_img_db", type=str)
    parser.add_argument("--train_img_db_gt", type=str)
    parser.add_argument("--train_datasets", type=str, nargs="*",
                        help="declared in the config JSON")
    parser.add_argument("--val_datasets", type=str, nargs="*")
    parser.add_argument("--mrm_prob", type=float, default=0.15)
    parser.set_defaults(learning_rate=5e-5, num_train_steps=60000,
                        warmup_steps=6000, train_batch_size=10240,
                        max_txt_len=220)
    return parser


if __name__ == "__main__":
    main(parse_with_config(get_parser()))
