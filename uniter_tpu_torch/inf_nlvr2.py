"""NLVR2 inference on one device (counterpart of the root ``inf_nlvr2.py``,
reference inf_nlvr2.py).

Reads a training directory of this package or of the JAX package
(``log/hps.json``, ``log/model.json``, ``ckpt/model_step_N.pt`` or
``.msgpack``) and the txt/img DBs, and writes ``results.csv`` with one
``identifier,label`` row per example (label ``True``/``False``), the format
of the official eval script (scripts/eval_nlvr2.py):

    python -m uniter_tpu_torch.inf_nlvr2 --txt_db DB --img_db DB \\
        --train_dir RUN --output_dir OUT [--device cuda]

Inference runs fp32 with dropout off, so the fused tails (K3-K6) never run;
attention takes K1 on the card. TF32 stays off.
"""

from __future__ import annotations

import argparse
import os

import torch

from uniter_tpu_torch.data.buckets import spec_from_dataset
from uniter_tpu_torch.data.loader import BucketLoader
from uniter_tpu_torch.data.nlvr2 import Nlvr2PairedDataset, Nlvr2TripletDataset
from uniter_tpu_torch.models.nlvr2 import MODEL_REGISTRY
from uniter_tpu_torch.training import infer
from uniter_tpu_torch.utils.const import IMG_DIM
from uniter_tpu_torch.utils.logger import LOGGER


def predict_labels(model, loader, device, paired: bool):
    """``[(identifier, "True"/"False")]`` in loader order; the paired models
    score rows (2i, 2i+1) as one example."""
    results = []
    for batch, out in infer.eval_batches(model.predict, loader, device,
                                         group=2 if paired else 1):
        preds = out.cpu().numpy().argmax(-1)[:len(batch["qids"])]
        results.extend((qid, "True" if p == 1 else "False")
                       for qid, p in zip(batch["qids"], preds))
    return results


def main(opts):
    from uniter_tpu_torch.data.img_db import DetectFeatDb
    from uniter_tpu_torch.data.txt_db import TxtTokDb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(opts.device)
    hps, model_json = infer.load_train_meta(opts.train_dir)
    cfg = infer.model_config_from_meta(
        model_json, device, type_vocab_size=3, dtype="float32",
        attention_impl=getattr(hps, "attention_impl", "xla"))
    model = MODEL_REGISTRY[hps.model](cfg, img_dim=IMG_DIM)
    model.load_state_dict(
        infer.load_params(infer.resolve_ckpt(opts.train_dir, opts.ckpt)),
        strict=True)
    model.to(device).eval()

    txt_db = TxtTokDb(opts.txt_db, max_txt_len=-1)
    img_db = DetectFeatDb(opts.img_db, conf_th=hps.conf_th,
                          max_bb=hps.max_bb, min_bb=hps.min_bb,
                          num_bb=hps.num_bb,
                          compress=bool(getattr(hps, "compressed_db",
                                                False)))
    paired = hps.model in ("paired", "paired-attn")
    cls = Nlvr2PairedDataset if paired else Nlvr2TripletDataset
    ds = cls(txt_db, img_db, use_img_type=hps.use_img_type)
    loader = BucketLoader(ds, spec_from_dataset(ds, opts.batch_size),
                          shuffle=False, drop_last=False)
    results = predict_labels(model, loader, device, paired)

    os.makedirs(opts.output_dir, exist_ok=True)
    out_csv = os.path.join(opts.output_dir, "results.csv")
    with open(out_csv, "w") as f:
        for qid, label in results:
            f.write(f"{qid},{label}\n")
    LOGGER.info("wrote %d predictions to %s", len(results), out_csv)
    return out_csv


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--txt_db", required=True)
    parser.add_argument("--img_db", required=True)
    parser.add_argument("--train_dir", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=10240)
    parser.add_argument("--device", default="cuda")
    return parser


if __name__ == "__main__":
    main(get_parser().parse_args())
