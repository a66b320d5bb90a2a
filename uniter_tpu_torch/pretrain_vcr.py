"""VCR second-stage pretraining on one device (counterpart of the root
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
"""

from __future__ import annotations

import argparse

import torch

from uniter_tpu_torch.data.loader import AccumLoader, BucketLoader, MetaLoader
from uniter_tpu_torch.data.pretrain_vcr import (
    MlmDatasetForVCR, MrcDatasetForVCR, MrfrDatasetForVCR)
from uniter_tpu_torch.models.pretrain_vcr import UniterForPretrainingForVCR
from uniter_tpu_torch.models.vcr import NUM_SPECIAL_TOKENS
from uniter_tpu_torch.pretrain import load_pretrain_heads, validate
from uniter_tpu_torch.training import driver
from uniter_tpu_torch.training.loop import MixedTaskLoop, pretrain_loss_units
from uniter_tpu_torch.training.optim import build_optimizer
from uniter_tpu_torch.training.sched import get_lr_schedule
from uniter_tpu_torch.training.step import TrainState, make_train_step
from uniter_tpu_torch.utils.const import IMG_DIM, IMG_LABEL_DIM
from uniter_tpu_torch.utils.logger import LOGGER
from uniter_tpu_torch.utils.misc import parse_with_config
from uniter_tpu_torch.utils.save import TrainStateSaver

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
                             worker_type=getattr(opts, "worker_type", None)),
                ratio)
    return out


def main(opts):
    driver.check_unported(opts)
    cfg = driver.model_config_from_opts(opts, type_vocab_size=4)
    driver.setup_run(opts, cfg)
    cfg = cfg.replace(vocab_size=cfg.vocab_size + NUM_SPECIAL_TOKENS)
    model = build_model(opts, cfg)

    img_db = driver.open_img_db(opts.train_img_db, opts)
    img_db_gt = driver.open_img_db(opts.train_img_db_gt, opts, gt=True)
    loaders = create_dataloaders(opts.train_datasets, opts, img_db_gt, img_db)
    for loader, _ in loaders.values():
        driver.check_token_range(cfg, loader.dataset)
    accum = opts.gradient_accumulation_steps
    if accum > 1:
        loaders = {name: (AccumLoader(loader, accum), ratio)
                   for name, (loader, ratio) in loaders.items()}
    meta = MetaLoader(loaders, accum_steps=1, seed=opts.seed)
    val_loaders = {}
    if opts.val_datasets:
        raw = create_dataloaders(opts.val_datasets, opts, img_db_gt, img_db,
                                 train=False)
        val_loaders = {name: loader for name, (loader, _r) in raw.items()}

    sched = get_lr_schedule(opts.learning_rate, opts.warmup_steps,
                            opts.num_train_steps)
    opt = build_optimizer(model, sched, **driver.optim_kwargs(opts))
    state = TrainState(step=0, model=model, opt=opt)
    saver = TrainStateSaver(opts.output_dir)
    if saver.restore(state, seed=opts.seed) is not None:
        LOGGER.info("resumed from step %d", state.step)

    step_fns = {}

    def get_step(task):
        if task not in step_fns:
            def loss_fn(m, batch, generator, _task=task):
                return m.scalar_loss(batch, _task, deterministic=False,
                                     generator=generator)
            step_fns[task] = make_train_step(
                loss_fn, loss_scale="sum", accum_steps=accum)
        return step_fns[task]

    def validate_fn(state, step):
        return (validate(state.model, val_loaders, opts.device)
                if val_loaders else {})

    cdt = cfg.compute_dtype
    loop = MixedTaskLoop(
        meta=meta, get_step=get_step, state=state, device=opts.device,
        num_train_steps=opts.num_train_steps, valid_steps=opts.valid_steps,
        log_steps=getattr(opts, "log_steps", 100), validate_fn=validate_fn,
        saver=saver, seed=opts.seed, loss_units_fn=pretrain_loss_units,
        transfer_dtype=None if cdt == torch.float32 else cdt,
        lr_schedule=sched, wire_codec=driver.wire_codec(opts),
        profile_dir=getattr(opts, "profile_dir", None))
    try:
        state = loop.run()
    finally:
        for loader in meta.loaders.values():
            getattr(loader, "base", loader).close()
    LOGGER.info("training finished at step %d", state.step)
    return state


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
