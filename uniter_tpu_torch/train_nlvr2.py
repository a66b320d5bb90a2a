"""NLVR2 fine-tuning (counterpart of the root
``train_nlvr2.py``, reference train_nlvr2.py):

    python -m uniter_tpu_torch.train_nlvr2 --config CONFIG.json \\
        [--device cuda] [--model paired-attn] [--num_train_steps N] ...

Same flags, txt/img DBs, ``--config`` JSON and recipe defaults as the root
driver (reference config/train-nlvr2-base-1gpu.json). The trunk's token-type
table has 3 rows; ``--checkpoint`` fills rows 0-1 from a 2-row reference
checkpoint and copies row 1 into row 2. The loss is the per-pair
cross-entropy weighted by ``ex_weight`` (the collate's padding pairs weigh
0); validation accuracy leaves out unlabeled examples (target -1). Writes
``log/`` and ``ckpt/`` under ``--output_dir`` as ``train_vqa`` does;
rerunning resumes; ``python -m uniter_tpu_torch.inf_nlvr2 --train_dir
OUTPUT_DIR`` predicts from it. On the card the default flags run the
attention kernels (K1/K2) and the fused dropout + residual + LayerNorm
tails (K3-K6).

Data-parallel over N processes (``training/driver.py``):

    torchrun --standalone --nproc_per_node N -m uniter_tpu_torch.train_nlvr2 ...
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from uniter_tpu_torch.data.loader import BucketLoader
from uniter_tpu_torch.data.nlvr2 import Nlvr2PairedDataset, Nlvr2TripletDataset
from uniter_tpu_torch.models.nlvr2 import MODEL_REGISTRY
from uniter_tpu_torch.parallel.collectives import global_sum
from uniter_tpu_torch.training import driver, infer
from uniter_tpu_torch.utils.const import IMG_DIM
from uniter_tpu_torch.utils.logger import LOGGER
from uniter_tpu_torch.utils.misc import parse_with_config

PAIRED = ("paired", "paired-attn")


def build_dataset(txt_path, img_path, opts):
    from uniter_tpu_torch.data.txt_db import TxtTokDb

    txt_db = TxtTokDb(txt_path, max_txt_len=opts.max_txt_len)
    img_db = driver.open_img_db(img_path, opts)
    cls = Nlvr2PairedDataset if opts.model in PAIRED else Nlvr2TripletDataset
    return cls(txt_db, img_db, use_img_type=opts.use_img_type)


def nlvr2_loss(model, batch, generator):
    """Per-example cross-entropy, averaged over the examples ``ex_weight``
    marks real (train_nlvr2.py:129-139) in the global batch: this rank's
    share (``global_sum``)."""
    per_ex = model(batch, True, deterministic=False, generator=generator)
    w = batch.get("ex_weight")
    if w is None:
        w = torch.ones_like(per_ex)
    w = w[:per_ex.shape[0]].float()
    return (per_ex * w).sum() / global_sum(w.sum()).clamp_min(1.0)


def validate(model, loader, paired: bool, device):
    """Accuracy over the labeled examples (train_nlvr2.py:71-96): outputs
    trimmed to the targets (one score row per pair), rows with weight 0 or
    target < 0 left out; each rank its share, the counts summed."""
    model.eval()
    n_correct, n_ex = 0, 0
    for batch, out in infer.eval_batches(model.predict, loader, device,
                                         group=2 if paired else 1):
        targets = np.asarray(batch["targets"])
        preds = out.float().cpu().numpy()[:len(targets)].argmax(-1)
        w = np.asarray(batch["ex_weight"])[:len(targets)]
        valid = (w > 0) & (targets >= 0)
        n_correct += int((preds[valid] == targets[valid]).sum())
        n_ex += int(valid.sum())
    model.train()
    n_correct, n_ex = infer.gather_sums(n_correct, n_ex)
    return {"acc": n_correct / max(n_ex, 1), "n_ex": n_ex}


def build_model(opts, cfg):
    model = MODEL_REGISTRY[opts.model](cfg, img_dim=IMG_DIM)
    driver.init_weights(model, cfg.initializer_range)
    driver.load_trunk_checkpoint(model, opts, n_type_rows=3, type_copy_row=1)
    return model.to(opts.device)


def main(opts):
    cfg = driver.model_config_from_opts(opts, type_vocab_size=3)
    driver.setup_run(opts, cfg)
    model = build_model(opts, cfg)

    train_ds = build_dataset(opts.train_txt_db, opts.train_img_db, opts)
    # dataset-derived buckets: the triplet model concatenates both images
    # in one row, up to 2 * max_bb regions
    train_loader = BucketLoader(
        train_ds, driver.bucket_spec(opts, train_ds), seed=opts.seed,
        loop=True, num_workers=opts.n_workers,
        worker_type=getattr(opts, "worker_type", None),
        **driver.shard_kw())
    evals = {}
    for split in ("val", "test"):
        txt, img = (getattr(opts, f"{split}_txt_db", None),
                    getattr(opts, f"{split}_img_db", None))
        if txt and img:
            ds = build_dataset(txt, img, opts)
            evals[split] = BucketLoader(
                ds, driver.bucket_spec(opts, ds, opts.val_batch_size),
                shuffle=False, drop_last=False, **driver.shard_kw())
    paired = opts.model in PAIRED

    def validate_fn(state, step):
        # the reference validates both splits each valid_steps
        # (train_nlvr2.py:207-219)
        logs = {}
        for split, loader in evals.items():
            res = validate(state.model, loader, paired, opts.device)
            LOGGER.info("step %d: %s acc %.4f", step, split, res["acc"])
            prefix = "" if split == "val" else f"{split}_"
            logs.update({f"{prefix}{k}": v for k, v in res.items()})
        return logs

    try:
        return driver.run_training(
            opts, model=model, train_loader=train_loader,
            loss_fn=lambda m, b, g: (nlvr2_loss(m, b, g), {}),
            validate_fn=validate_fn)
    finally:
        train_loader.close()


def get_parser():
    parser = argparse.ArgumentParser()
    driver.add_common_args(parser)
    for split in ("train", "val", "test"):
        parser.add_argument(f"--{split}_txt_db", type=str)
        parser.add_argument(f"--{split}_img_db", type=str)
    parser.add_argument("--model", default="paired-attn",
                        choices=list(MODEL_REGISTRY))
    parser.add_argument("--use_img_type", type=int, default=1)
    # reference recipe defaults (config/train-nlvr2-base-1gpu.json)
    parser.set_defaults(train_batch_size=10240, val_batch_size=10240,
                        learning_rate=3e-5, valid_steps=500,
                        num_train_steps=8000, warmup_steps=800, seed=77)
    return parser


if __name__ == "__main__":
    main(parse_with_config(get_parser()))
