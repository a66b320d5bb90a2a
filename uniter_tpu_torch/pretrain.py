"""UNITER pretraining (counterpart of the root ``pretrain.py``,
reference pretrain.py):

    python -m uniter_tpu_torch.pretrain --config CONFIG.json \\
        [--device cuda] [--num_train_steps N] ...

Same flags, txt/img DBs and ``--config`` JSON as the root driver. Builds one
bucketed loader per (corpus x task) from the config's ``train_datasets``
declaration (pretrain.py:116-165), mixes the tasks with a seeded
``MetaLoader`` and trains ``UniterForPretraining`` on the per-task scalar
losses (MLM / MRFR / ITM + ``itm_ot_lambda`` x WRA-OT / MRC(-kl)), one step
function per task. Validation reports MLM accuracy, MRFR loss per feature,
MRC accuracy and ITM accuracy. Writes ``log/`` and ``ckpt/`` under
``--output_dir`` as the fine-tune drivers do; rerunning resumes, with the
task mix fast-forwarded past the steps already taken.

On the card the default flags run attention through K1/K2, the dropout +
residual + LayerNorm tails through K3-K6 and the OT plan of every ITM step
through K7 (one launch); on the CPU their plain versions. The OT version
follows ``--device`` alone.

Data-parallel over N processes (``training/driver.py``):

    torchrun --standalone --nproc_per_node N -m uniter_tpu_torch.pretrain ...
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from uniter_tpu_torch.data.datasets import ConcatDataset, ImageDbGroup
from uniter_tpu_torch.data.itm import ItmDataset
from uniter_tpu_torch.data.loader import AccumLoader, BucketLoader, MetaLoader
from uniter_tpu_torch.data.mlm import MlmDataset
from uniter_tpu_torch.data.mrm import MrcDataset, MrfrDataset
from uniter_tpu_torch.models.checkpoint import pretrain_head_state_dict
from uniter_tpu_torch.models.pretrain import UniterForPretraining
from uniter_tpu_torch.training import driver, infer
from uniter_tpu_torch.training.loop import MixedTaskLoop, pretrain_loss_units
from uniter_tpu_torch.training.optim import build_optimizer
from uniter_tpu_torch.training.sched import get_lr_schedule
from uniter_tpu_torch.training.step import TrainState, make_train_step
from uniter_tpu_torch.utils.const import IMG_DIM, IMG_LABEL_DIM
from uniter_tpu_torch.utils.logger import LOGGER
from uniter_tpu_torch.utils.misc import parse_with_config
from uniter_tpu_torch.utils.save import TrainStateSaver


def load_pretrain_heads(model, sd):
    """Restore the MLM/MRFR/MRC/ITM head tensors a checkpoint holds
    (continuing pretraining; reference from_pretrained loads them too). A
    head tensor of another shape is skipped with a warning, where a trunk
    tensor raises: the JAX driver merges the heads with
    ``strict_shapes=False``."""
    own = model.state_dict()
    take = {}
    for key, arr in pretrain_head_state_dict(sd).items():
        if key not in own:
            continue
        if tuple(arr.shape) != tuple(own[key].shape):
            LOGGER.warning("shape mismatch for %s: ckpt %s vs model %s "
                           "-- skipped", key, tuple(arr.shape),
                           tuple(own[key].shape))
            continue
        take[key] = torch.from_numpy(np.ascontiguousarray(arr))
    model.load_state_dict(take, strict=False)
    LOGGER.info("loaded %d pretraining-head tensors", len(take))
    return model


def build_model(opts, cfg):
    # the OT version follows the device: K7 on the card, the plain loop on
    # the CPU
    on_cuda = torch.device(opts.device).type == "cuda"
    model = UniterForPretraining(cfg, img_dim=IMG_DIM,
                                 img_label_dim=IMG_LABEL_DIM,
                                 ot_impl="cuda" if on_cuda else "xla")
    driver.init_weights(model, cfg.initializer_range)
    driver.load_trunk_checkpoint(model, opts, extra=load_pretrain_heads)
    return model.to(opts.device)


DATASET_REGISTRY = {
    "mlm": lambda txt, img, opts, **kw: MlmDataset(txt, img, **kw),
    "mrfr": lambda txt, img, opts, **kw: MrfrDataset(
        opts.mrm_prob, txt, img, **kw),
    "mrc": lambda txt, img, opts, **kw: MrcDataset(
        opts.mrm_prob, txt, img, **kw),
    "mrc-kl": lambda txt, img, opts, **kw: MrcDataset(
        opts.mrm_prob, txt, img, **kw),
    # the reference configs spell it "mrckl" (config/pretrain-*.json)
    "mrckl": lambda txt, img, opts, **kw: MrcDataset(
        opts.mrm_prob, txt, img, **kw),
    "itm": lambda txt, img, opts, **kw: ItmDataset(
        txt, img, neg_sample_p=opts.itm_neg_prob, **kw),
}


def create_dataloaders(datasets_cfg, opts, train=True) -> Dict[str, tuple]:
    """name -> (loader, ratio); name is '{task}_{corpus-name}' (reference
    pretrain.py:116-165). Validation loaders do one full pass and never
    drop tail examples (drop_last=False)."""
    from uniter_tpu_torch.data.txt_db import TxtTokDb

    compress = (bool(getattr(opts, "compressed_db", False))
                and not opts.uncompressed_db)
    img_group = ImageDbGroup(opts.conf_th, opts.max_bb, opts.min_bb,
                             opts.num_bb, compress=compress)
    out = {}
    for dset in datasets_cfg:
        name = dset["name"]
        txt_dbs = dset["db"] if isinstance(dset["db"], list) else [dset["db"]]
        img_dirs = (dset["img"] if isinstance(dset["img"], list)
                    else [dset["img"]])
        for task, ratio in zip(dset["tasks"], dset.get(
                "mix_ratio", [1] * len(dset["tasks"]))):
            build = DATASET_REGISTRY[task]
            parts = []
            for txt_path, img_dir in zip(txt_dbs, img_dirs):
                txt_db = TxtTokDb(txt_path, max_txt_len=opts.max_txt_len)
                parts.append(build(txt_db, img_group[img_dir], opts))
            ds = parts[0] if len(parts) == 1 else ConcatDataset(parts)
            spec = driver.bucket_spec(
                opts, ds, budget=None if train else opts.val_batch_size)
            loader = BucketLoader(
                ds, spec, collate=type(parts[0]).collate, seed=opts.seed,
                loop=train, shuffle=train, drop_last=train,
                num_workers=opts.n_workers,
                worker_type=getattr(opts, "worker_type", None),
                **driver.shard_kw())
            out[f"{task}_{name}"] = (loader, ratio)
    return out


def validate(model, val_loaders, device):
    """Per-task validation (reference pretrain.py:364-544): MLM accuracy,
    MRFR loss per feature, MRC(-kl) accuracy against the argmax of the soft
    label (background excluded), ITM accuracy (no OT). Reductions use the
    batches' own masks, so the collate's padding rows never count; each
    rank takes its share and the counts are summed over the ranks."""
    model.eval()
    logs = {}
    for name, loader in val_loaders.items():
        task = name.split("_")[0]
        n_correct, n_word, loss_sum = 0, 0, 0.0
        t0 = time.time()
        if task.startswith("itm"):
            def pred(b):
                return model.forward_itm(b, False, False,
                                         deterministic=True)[0]
        else:
            def pred(b, _task=task):
                return model(b, _task, False, deterministic=True)
        for batch, out in infer.eval_batches(pred, loader, device):
            out = out.float().cpu().numpy()
            if task == "mlm":
                tgt = np.asarray(batch["mlm_tgt"])
                valid = tgt != -1
                n_correct += int((out.argmax(-1) == tgt)[valid].sum())
                n_word += int(valid.sum())
            elif task == "mrfr":
                tgtf = np.asarray(batch["feat_targets"], np.float32)
                w = np.asarray(batch["mrm_valid"])[..., None]
                loss_sum += float((np.square(out - tgtf) * w).sum()
                                  / out.shape[-1])
                n_word += int(w.sum())
            elif task.startswith("mrc"):
                tgt = np.asarray(batch["label_targets"])
                valid = np.asarray(batch["mrm_valid"]) > 0
                # acc vs argmax of soft label, background excluded
                # (reference pretrain.py:480-490)
                lab = tgt[..., 1:].argmax(-1) + 1
                n_correct += int((out.argmax(-1) == lab)[valid].sum())
                n_word += int(valid.sum())
            elif task.startswith("itm"):
                tgt = np.asarray(batch["targets"])
                valid = tgt != -1
                n_correct += int((out.argmax(-1) == tgt)[valid].sum())
                n_word += int(valid.sum())
        n_correct, n_word, loss_sum = infer.gather_sums(n_correct, n_word,
                                                        loss_sum)
        if task == "mrfr":
            logs[f"{name}_loss"] = loss_sum / max(n_word, 1)
        else:
            logs[f"{name}_acc"] = n_correct / max(n_word, 1)
        # reference validate_* log tok_per_s / feat_per_s
        # (pretrain.py:380-388, 411-413, 441-443)
        unit = "feat" if task.startswith("mr") else "tok"
        logs[f"{name}_{unit}_per_s"] = n_word / max(time.time() - t0, 1e-9)
    model.train()
    return logs


def main(opts):
    cfg = driver.model_config_from_opts(opts)
    driver.setup_run(opts, cfg)
    model = build_model(opts, cfg)
    LOGGER.info("pretraining heads: ot %s, itm_ot_lambda %g", model.ot_impl,
                opts.itm_ot_lambda)

    loaders = create_dataloaders(opts.train_datasets, opts)
    for loader, _ in loaders.values():
        driver.check_token_range(cfg, loader.dataset)
    accum = opts.gradient_accumulation_steps
    if accum > 1:
        loaders = {name: (AccumLoader(loader, accum), ratio)
                   for name, (loader, ratio) in loaders.items()}
    meta = MetaLoader(loaders, accum_steps=1, seed=opts.seed)
    val_loaders = {}
    if opts.val_datasets:
        raw = create_dataloaders(opts.val_datasets, opts, train=False)
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
            lam = opts.itm_ot_lambda if task.startswith("itm") else 0.0

            def loss_fn(m, batch, generator, _task=task, _lam=lam):
                return m.scalar_loss(batch, _task, ot_lambda=_lam,
                                     deterministic=False,
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
    parser.add_argument("--train_datasets", type=str, nargs="*",
                        help="declared in the config JSON")
    parser.add_argument("--val_datasets", type=str, nargs="*")
    parser.add_argument("--mrm_prob", type=float, default=0.15)
    parser.add_argument("--itm_neg_prob", type=float, default=0.5)
    parser.add_argument("--itm_ot_lambda", type=float, default=0.1)
    parser.add_argument("--uncompressed_db", action="store_true",
                        help="deprecated: uncompressed is already the "
                             "default (reference parity); when given it "
                             "takes precedence over --compressed_db")
    parser.set_defaults(learning_rate=5e-5, num_train_steps=200000,
                        warmup_steps=10000, train_batch_size=10240,
                        max_txt_len=60)
    return parser


if __name__ == "__main__":
    main(parse_with_config(get_parser()))
