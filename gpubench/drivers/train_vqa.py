"""Kind ``train_vqa``: VQA fine-tuning through the port's ``TrainLoop``,
built as ``uniter_tpu_torch.train_vqa`` builds it (the txt and img DBs of
the port's writers, ``VqaDataset``, ``BucketLoader`` over the driver's
bucket grid, ``UniterForVisualQuestionAnswering``, ``place_state`` with
the recipe's optimizer, ``vqa_loss``), with the harness's weights, feed
tap and window."""

from __future__ import annotations

import argparse
import os

import torch

from gpubench import training
from gpubench.corpus import (ImageCorpus, TextCorpus, write_image_db,
                             write_text_db)
from gpubench.harness import make_params, reference_shapes
from gpubench.reference.model import (Forward, Numerics, RefConfig, RefModel,
                                      decays, init_kind)
from gpubench.reference.optim import RefAdamW, warmup_linear_lr
from gpubench.tracing import FeedTap
from gpubench.yardstick import train_batch_work

COMPARED = ("input_ids", "position_ids", "img_feat", "img_pos_feat",
            "attn_mask", "ex_weight", "txt_lens", "num_bbs", "targets")


def opts_for(ctx, rc: dict) -> argparse.Namespace:
    """The CLI's options as the recipe sets them."""
    return argparse.Namespace(
        model_config=ctx.cfg_path, device=ctx.device, dtype=rc["dtype"],
        attention_impl="auto", block_fusion="auto", dropout_impl="xla",
        remat=False, dropout=rc["dropout"], max_txt_len=rc["max_txt_len"],
        conf_th=rc["conf_th"], max_bb=rc["max_bb"], min_bb=rc["min_bb"],
        num_bb=rc["num_bb"], compressed_db=False,
        train_batch_size=rc["token_budget"], betas=rc["betas"],
        weight_decay=rc["weight_decay"], grad_norm=rc["grad_norm"],
        optim="adamw", fused_adamw=1, moment_dtype=rc["moment_dtype"],
        param_dtype="float32", fsdp=False, learning_rate=rc["lr"],
        warmup_steps=rc["warmup_steps"],
        num_train_steps=rc["num_train_steps"], lr_mul=rc["lr_mul"])


def reference_model(ctx, num_answer, device="meta"):
    with torch.device(device):
        return RefModel(RefConfig.from_dict(
            ctx.cfg, hidden_dropout_prob=ctx.mix["recipe"]["dropout"],
            attention_probs_dropout_prob=ctx.mix["recipe"]["dropout"]),
            "vqa", num_answer)


def run(ctx):
    from uniter_tpu_torch.data.loader import BucketLoader
    from uniter_tpu_torch.data.txt_db import TxtTokDb
    from uniter_tpu_torch.data.vqa import VqaDataset
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch.train_vqa import vqa_loss
    from uniter_tpu_torch.training import driver
    from uniter_tpu_torch.training.loop import TrainLoop
    from uniter_tpu_torch.training.sched import get_lr_schedule

    mix, rc = ctx.mix, ctx.mix["recipe"]
    c = mix["corpus"]
    n_ans = c["num_answer"]
    images = ImageCorpus(c["corpus_seed"], c["n_img"], c["regions"], False)
    img_path = write_image_db(ctx.dirs["corpus"], images, {
        k: c[k] for k in ("corpus_seed", "n_img", "regions")})
    texts = TextCorpus(ctx.seeds.data, c["n_txt"], c["txt_len"], images,
                       num_answer=n_ans, labels_per_text=c["labels_per_q"],
                       prefix="q", layout_seed=c["layout_seed"])
    txt_path = write_text_db(os.path.join(ctx.dirs["corpus"], "txt-vqa"),
                             texts)

    opts = opts_for(ctx, rc)
    ds = VqaDataset(n_ans, TxtTokDb(txt_path, max_txt_len=rc["max_txt_len"]),
                    driver.open_img_db(img_path, opts))
    loader = BucketLoader(ds, driver.bucket_spec(opts, ds),
                          seed=c["order_seed"], loop=True,
                          num_workers=rc["n_workers"], worker_type="thread")
    cfg = driver.model_config_from_opts(opts)
    ref_meta = reference_model(ctx, n_ans)
    shapes, kinds = reference_shapes(ref_meta), init_kind(ref_meta)
    std = ctx.cfg["initializer_range"]
    with torch.device("meta"):
        model = UniterForVisualQuestionAnswering(cfg, img_dim=2048,
                                                 num_answer=n_ans)
    model = model.to_empty(device=ctx.device)
    model.load_state_dict(make_params(shapes, kinds, ctx.seeds.weights,
                                      ctx.device, std))
    sched = get_lr_schedule(rc["lr"], rc["warmup_steps"],
                            rc["num_train_steps"])
    state = driver.place_state(model, sched, lr_mul=rc["lr_mul"],
                               lr_mul_paths=("vqa_",),
                               **driver.optim_kwargs(opts))
    if ctx.fault == "stale":
        training.plant_stale(state)

    caps = training.Captures()
    n_check = mix["check"]["steps"]

    def loss_fn(m, batch, generator):
        if ctx.fault == "half_batch":
            w = batch["ex_weight"].clone()
            w[w.shape[0] // 2:] = 0
            batch = {**batch, "ex_weight": w}
        loss = vqa_loss(m, batch, generator, n_ans)
        if len(caps.losses) < n_check:
            caps.losses.append(loss.detach())
        return loss, {}

    warm = loader.example_batches()
    tap = FeedTap(loader, lambda b: train_batch_work("vqa", b, ctx.cfg, n_ans),
                  keep=n_check, warm=warm)
    initial = training.initial_params(shapes, kinds, ctx.seeds.weights,
                                      ctx.device, std)
    control, profiler = training.make_window(
        ctx, len(warm), caps, state, initial, n_check,
        profile_steps=mix["window"]["profile_steps"])
    loop = TrainLoop(
        loss_fn=loss_fn, state=state, train_loader=tap, device=ctx.device,
        num_train_steps=rc["num_train_steps"], valid_steps=0,
        log_steps=rc["log_steps"], validate_fn=None, saver=None,
        seed=ctx.seeds.loop, transfer_dtype=cfg.compute_dtype,
        lr_schedule=sched, preempt=control)
    try:
        loop.run()
    finally:
        loader.close()
    e2e = training.end_to_end(ctx, control, tap)
    prog = training.program_numbers(caps)
    kept = tap.kept
    record = training.Record(control, tap, profiler)
    del loop, state, model
    training.free()

    def check(control=False):
        return check_steps(ctx, kept, texts, images, prog, control)

    return e2e, record, check


def check_steps(ctx, kept, texts, images, prog, control=False):
    """The reference's first steps on its own rebuild of the kept batches,
    compared with the program's (and with ``control`` the float8
    reference's, compared the same way): {"program": numbers, "control":
    numbers}."""
    from gpubench.reference.batches import vqa_batch

    rc = ctx.mix["recipe"]
    n_ans = ctx.mix["corpus"]["num_answer"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mismatch, batches = 0, []
    for b in kept:
        t_b, r_b = b["input_ids"].shape[1], b["img_feat"].shape[1]
        mine = vqa_batch(list(b["qids"]), t_b, r_b, texts, images, n_ans)
        mismatch += training.count_mismatch(b, mine, COMPARED)
        batches.append((None, {k: torch.from_numpy(v).to(ctx.device)
                               for k, v in mine.items()}))

    def steps(numerics):
        model = reference_model(ctx, n_ans).to_empty(device=ctx.device)
        shapes, kinds = reference_shapes(model), init_kind(model)
        model.load_state_dict(make_params(
            shapes, kinds, ctx.seeds.weights, ctx.device,
            ctx.cfg["initializer_range"]))
        opt = RefAdamW(
            dict(model.named_parameters()),
            lr_fn=warmup_linear_lr(rc["lr"], rc["warmup_steps"],
                                   rc["num_train_steps"]),
            betas=tuple(rc["betas"]), weight_decay=rc["weight_decay"],
            grad_norm=rc["grad_norm"], decay=decays(model),
            lr_mul={n: rc["lr_mul"] for n, _ in model.named_parameters()
                    if "vqa_" in n})
        fwd = Forward(model, numerics)
        out = training.reference_steps(
            model, lambda _task, b, seeds: fwd.vqa_loss(b, seeds), batches,
            ctx.seeds.loop, opt)
        del model, opt, fwd
        training.free()
        return out

    ref = steps(Numerics())
    out = {"program": {**training.compare(prog, ref, control),
                       "rebuild_mismatch": float(mismatch)}}
    if control:
        out["control"] = training.compare(steps(Numerics(fp8=True)), ref,
                                          True)
    return out
