"""Image-text retrieval inference on one device or several (counterpart of
the root ``inf_itm.py``, reference inf_itm.py): the full |txt| x |img|
score matrix (fp16 on disk) and R@1/5/10 in both directions.

    python -m uniter_tpu_torch.inf_itm --txt_db DB --img_db DB \\
        --train_dir RUN --output_dir OUT [--device cuda] [--dtype float32]
    python -m uniter_tpu_torch.inf_itm --txt_db DB --img_db DB \\
        --model_config MODEL.json --ckpt PRETRAINED.pt --output_dir OUT

With ``--train_dir`` it reads a training directory of this package or of
the JAX package (``log/hps.json``, ``log/model.json``, ``ckpt/
model_step_N.pt`` or ``.msgpack``). Without one it evaluates zero-shot: the
architecture comes from ``--model_config``, the trunk and the ITM head from
a reference-format ``--ckpt`` ``.pt``, and ``rank_output`` is seeded from
the ITM head's match row (reference inf_itm.py:60-61). Writes
``score_matrix.npz`` (score_matrix fp16, txt_ids, img_ids) and
``results.json``. ``--eval_impl fast`` (default) scores device-resident
tiles (``utils/itm_fast.py``), ``batched`` the per-text minibatches.
Attention takes K1 on the card when the run's policy says so; the model
config's ``ffn_impl`` (``pallas``/``cuda``) runs the FFN through K9. TF32
stays off. Under ``torchrun`` each rank scores a stride of the texts, the
rows are gathered (``utils/itm_fast.py``) and rank 0 writes.
"""

from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from uniter_tpu_torch.data.itm import ItmEvalDataset
from uniter_tpu_torch.models.itm import UniterForImageTextRetrieval
from uniter_tpu_torch.parallel.collectives import process_index
from uniter_tpu_torch.training import infer
from uniter_tpu_torch.utils.const import IMG_DIM
from uniter_tpu_torch.utils.itm_eval import inference_score_matrix, itm_eval
from uniter_tpu_torch.utils.logger import LOGGER


def load_model(opts, device):
    """(model on ``device`` in eval mode, hps) from a training directory or,
    zero-shot, from ``--model_config`` and a ``.pt``."""
    from uniter_tpu_torch.models.itm import seed_rank_head
    from uniter_tpu_torch.training import driver

    if opts.train_dir:
        hps, model_json = infer.load_train_meta(opts.train_dir)
    else:
        if not (opts.model_config and opts.ckpt):
            raise SystemExit(
                "zero-shot inference (no --train_dir) needs "
                "--model_config and --ckpt")
        with open(opts.model_config) as f:
            model_json = json.load(f)
        hps = SimpleNamespace(
            conf_th=opts.conf_th, max_bb=opts.max_bb, min_bb=opts.min_bb,
            num_bb=opts.num_bb, compressed_db=opts.compressed_db)
    cfg = infer.model_config_from_meta(
        model_json, device, dtype=opts.dtype,
        attention_impl=getattr(hps, "attention_impl", "xla"))
    model = UniterForImageTextRetrieval(cfg, img_dim=IMG_DIM)
    if opts.train_dir:
        model.load_state_dict(
            infer.load_params(infer.resolve_ckpt(opts.train_dir, opts.ckpt)),
            strict=True)
    else:
        torch.manual_seed(0)
        driver.init_weights(model, cfg.initializer_range)
        driver.load_trunk_checkpoint(
            model, SimpleNamespace(checkpoint=opts.ckpt), extra=seed_rank_head)
    LOGGER.info("device: %s (attention %s, layer_norm %s, ffn %s, dtype %s)",
                device, cfg.attention_impl, cfg.layer_norm_impl, cfg.ffn_impl,
                cfg.dtype)
    return model.to(device).eval(), hps


def main(opts):
    from uniter_tpu_torch.data.img_db import DetectFeatDb
    from uniter_tpu_torch.data.txt_db import TxtTokDb
    from uniter_tpu_torch.training.driver import init_process

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_process(opts)
    device = torch.device(opts.device)
    model, hps = load_model(opts, device)
    txt_db = TxtTokDb(opts.txt_db, max_txt_len=-1)
    img_db = DetectFeatDb(opts.img_db, conf_th=hps.conf_th,
                          max_bb=hps.max_bb, min_bb=hps.min_bb,
                          num_bb=hps.num_bb,
                          compress=bool(getattr(hps, "compressed_db",
                                                False)))
    ds = ItmEvalDataset(txt_db, img_db, mini_batch_size=opts.batch_size)
    if opts.eval_impl == "fast":
        from uniter_tpu_torch.utils.itm_fast import fast_score_matrix

        mat, txt_ids = fast_score_matrix(
            model, ds, opts.txt_bucket, opts.img_bucket,
            txt_tile=opts.txt_tile, img_tile=opts.img_tile,
            dtype=model.uniter.config.dtype)
    else:
        mat, txt_ids = inference_score_matrix(
            model.predict, ds, opts.txt_bucket, opts.img_bucket, device)
    logs = itm_eval(mat, txt_ids, ds.all_img_ids, ds.txt2img, ds.img2txts)
    if process_index() > 0:
        return logs
    os.makedirs(opts.output_dir, exist_ok=True)
    np.savez(
        os.path.join(opts.output_dir, "score_matrix.npz"),
        score_matrix=mat.astype(np.float16),
        txt_ids=np.asarray(txt_ids), img_ids=np.asarray(ds.all_img_ids))
    with open(os.path.join(opts.output_dir, "results.json"), "w") as f:
        json.dump(logs, f, indent=2)
    LOGGER.info("retrieval results: %s", logs)
    return logs


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--txt_db", required=True)
    parser.add_argument("--img_db", required=True)
    parser.add_argument("--train_dir", default=None,
                        help="training output dir; omit for zero-shot "
                             "eval of a pretrained .pt (then pass "
                             "--model_config and --ckpt)")
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--model_config", default=None,
                        help="model json for zero-shot (no --train_dir)")
    parser.add_argument("--conf_th", type=float, default=0.2)
    parser.add_argument("--max_bb", type=int, default=100)
    parser.add_argument("--min_bb", type=int, default=10)
    parser.add_argument("--num_bb", type=int, default=36)
    parser.add_argument("--compressed_db", action="store_true")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=400)
    parser.add_argument("--txt_bucket", type=int, default=64)
    parser.add_argument("--img_bucket", type=int, default=64)
    parser.add_argument("--dtype", default="float32",
                        help="compute dtype of the scoring (float32 or "
                             "bfloat16)")
    parser.add_argument("--eval_impl", default="fast",
                        choices=["fast", "batched"],
                        help="fast: device-resident tiled scoring; batched: "
                             "per-text minibatches (reference-style)")
    parser.add_argument("--txt_tile", type=int, default=32)
    parser.add_argument("--img_tile", type=int, default=128)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dist_backend", default=None,
                        choices=["nccl", "gloo"],
                        help="process group backend under torchrun")
    return parser


if __name__ == "__main__":
    main(get_parser().parse_args())
