"""VQA inference (counterpart of the root ``inf_vqa.py``), on one device
or over N:

Reads a JAX training directory (``log/hps.json``, ``log/model.json``,
``ckpt/model_step_N.msgpack``) and the same txt/img DBs, and writes the
same ``results.json`` ``[{question_id, answer}]`` and, with
``--save_logits``, ``logits.npz`` (fp16 rows keyed by question id):

    python -m uniter_tpu_torch.inf_vqa --txt_db DB --img_db DB \\
        --train_dir RUN --output_dir OUT [--device cuda]
    torchrun --standalone --nproc_per_node N -m uniter_tpu_torch.inf_vqa ...

Over N processes each rank answers its block of every batch, the answers
are gathered into the one-process order and rank 0 writes the same files.

Inference runs fp32. TF32 matmuls stay off (set here and stated), so the
fp32 products keep full precision; turning TF32 on is a separate decision.

The model config's ``model_type`` (default "uniter") chooses the
model. "beit3" serves ``models.beit3``'s
``Beit3ForVisualQuestionAnswering`` in the model config's ``dtype``: the
run directory holds its config (``log/model.json``, torchscale's keys),
``log/hps.json`` (``num_answer``) and a ``.pt`` state dict under
torchscale's names; ``--img_db`` is a pixel store (``data/pixel_db.py``)
and ``--txt_db`` a tokenized txt DB whose tokens are the model's
vocabulary's. It runs in one process.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from uniter_tpu_torch.data.buckets import spec_from_dataset
from uniter_tpu_torch.data.loader import BucketLoader
from uniter_tpu_torch.data.vqa import VqaDataset
from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
from uniter_tpu_torch.parallel.collectives import process_index
from uniter_tpu_torch.training import infer
from uniter_tpu_torch.utils.const import IMG_DIM
from uniter_tpu_torch.utils.logger import LOGGER


def answer_questions(model, loader, label2ans, device, *,
                     keep_logits: bool = False, prefetch: int = 2):
    """The loop over batches: ``(results, logits)`` where results is
    ``[{question_id, answer}]`` in loader order and logits maps each
    question id to its fp32 row (filled only with ``keep_logits``); over
    several processes every rank's, in the one-process order
    (``infer.gather_batches``)."""
    per_batch = []
    for batch, out in infer.eval_batches(model.predict, loader, device,
                                         prefetch):
        out = out.cpu().numpy()
        per_batch.append([
            ({"question_id": qid, "answer": label2ans[int(row.argmax())]},
             row if keep_logits else None)
            for qid, row in zip(batch["qids"], out)])
    rows = infer.gather_batches(loader, per_batch)
    results = [r for r, _ in rows]
    logits = {str(r["question_id"]): row for r, row in rows if keep_logits}
    return results, logits


def load_label2ans(opts, num_answer: int) -> dict:
    """Resolution order (reference inf_vqa.py:45-47 reads the training
    run's dumped copy): explicit flag > train_dir/ckpt/ans2label.json >
    in-tree artifact (if it matches the head width) > index labels."""
    from uniter_tpu_torch.utils.vqa_answers import default_ans2label_path

    a2l_path = opts.ans2label
    if not a2l_path:
        cand = os.path.join(opts.train_dir, "ckpt", "ans2label.json")
        if os.path.exists(cand):
            a2l_path = cand
    ans2label = None
    if a2l_path:
        with open(a2l_path) as f:
            ans2label = json.load(f)
    else:
        cand = default_ans2label_path()
        if cand is not None:
            with open(cand) as f:
                d = json.load(f)
            if len(d) == num_answer:
                ans2label = d
    if ans2label is None:
        ans2label = {str(i): i for i in range(num_answer)}
    return {v: k for k, v in ans2label.items()}


def main(opts):
    from uniter_tpu_torch.data.img_db import DetectFeatDb
    from uniter_tpu_torch.data.txt_db import TxtTokDb

    from uniter_tpu_torch.training.driver import init_process, shard_kw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_process(opts)
    device = torch.device(opts.device)
    hps, model_json = infer.load_train_meta(opts.train_dir)
    model_type = model_json.get("model_type", "uniter")
    if model_type == "beit3":
        return main_beit3(opts, hps, model_json, device)
    if model_type != "uniter":
        raise ValueError(f"unknown model_type {model_type!r}")
    cfg = infer.model_config_from_meta(
        model_json, device, dtype="float32",
        attention_impl=getattr(hps, "attention_impl", "xla"))
    num_answer = hps.num_answer
    model = UniterForVisualQuestionAnswering(
        cfg, img_dim=IMG_DIM, num_answer=num_answer)
    model.load_state_dict(
        infer.load_params(infer.resolve_ckpt(opts.train_dir, opts.ckpt)),
        strict=True)
    model.to(device).eval()
    label2ans = load_label2ans(opts, num_answer)

    txt_db = TxtTokDb(opts.txt_db, max_txt_len=-1)
    img_db = DetectFeatDb(opts.img_db, conf_th=hps.conf_th,
                          max_bb=hps.max_bb, min_bb=hps.min_bb,
                          num_bb=hps.num_bb,
                          compress=bool(getattr(hps, "compressed_db",
                                                False)))
    ds = VqaDataset(num_answer, txt_db, img_db)
    loader = BucketLoader(
        ds, spec_from_dataset(ds, opts.batch_size),
        shuffle=False, drop_last=False, **shard_kw())
    results, all_logits = answer_questions(
        model, loader, label2ans, device, keep_logits=opts.save_logits)
    return write_results(opts, results, all_logits)


def main_beit3(opts, hps, model_json, device):
    """BEiT-3 VQA from a pixel store and a txt DB (module docstring)."""
    from uniter_tpu_torch.data.pixel_db import (
        Beit3BatchLoader, Beit3VqaDataset, PixelDb)
    from uniter_tpu_torch.data.txt_db import TxtTokDb
    from uniter_tpu_torch.models.beit3 import (
        Beit3Config, Beit3ForVisualQuestionAnswering, resolve_beit3_policies)
    from uniter_tpu_torch.parallel.collectives import data_size

    if data_size() > 1:
        raise ValueError("BEiT-3 inference runs in one process")
    cfg = resolve_beit3_policies(Beit3Config.from_dict(model_json), device)
    model = Beit3ForVisualQuestionAnswering(cfg, num_answer=hps.num_answer)
    sd = torch.load(infer.resolve_ckpt(opts.train_dir, opts.ckpt),
                    map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=True)
    model.to(device).eval()
    label2ans = load_label2ans(opts, hps.num_answer)
    ds = Beit3VqaDataset(TxtTokDb(opts.txt_db, max_txt_len=-1),
                         PixelDb(opts.img_db), cfg.bos_token_id,
                         cfg.eos_token_id)
    loader = Beit3BatchLoader(ds, opts.batch_size, cfg.pad_token_id)
    results, all_logits = answer_questions(
        model, loader, label2ans, device, keep_logits=opts.save_logits)
    return write_results(opts, results, all_logits)


def write_results(opts, results, all_logits):
    """``results.json`` (and ``logits.npz``) under ``--output_dir`` on
    rank 0; the path of ``results.json``."""
    out = os.path.join(opts.output_dir, "results.json")
    if process_index() > 0:
        return out
    os.makedirs(opts.output_dir, exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f)
    if opts.save_logits:
        np.savez(os.path.join(opts.output_dir, "logits.npz"),
                 **{k: v.astype(np.float16) for k, v in all_logits.items()})
    LOGGER.info("wrote %d answers to %s", len(results), out)
    return out


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--txt_db", required=True)
    parser.add_argument("--img_db", required=True)
    parser.add_argument("--train_dir", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--ans2label", default=None)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=8192)
    parser.add_argument("--save_logits", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dist_backend", default=None,
                        choices=["nccl", "gloo"],
                        help="process group backend under torchrun")
    return parser


if __name__ == "__main__":
    main(get_parser().parse_args())
