"""Kind ``pretrain_mix``: pretraining through the port's ``MixedTaskLoop``,
built as ``uniter_tpu_torch.pretrain`` builds it (a txt and an img DB of
the port's writers, one dataset and ``BucketLoader`` a task over the
driver's bucket grid, ``MetaLoader`` at the mix ratio,
``UniterForPretraining`` with K7 on the card, ``build_optimizer``, a step
function a task around ``scalar_loss``), with the harness's weights, feed
tap and window.

The harness's datasets are the port's, each tagging its records with the
text id, the image, the ITM target and the state of the record's random
stream, so the reference can rebuild the rows and draw their masks
again."""

from __future__ import annotations

import os

import numpy as np
import torch

from gpubench import training
from gpubench.corpus import (ImageCorpus, TextCorpus, write_image_db,
                             write_text_db)
from gpubench.drivers.train_vqa import opts_for
from gpubench.harness import make_params, reference_shapes
from gpubench.reference.model import (Forward, Numerics, RefConfig, RefModel,
                                      decays, init_kind)
from gpubench.reference.optim import RefAdamW, warmup_linear_lr
from gpubench.tracing import FeedTap
from gpubench.yardstick import train_batch_work

COMMON = ("input_ids", "position_ids", "img_feat", "img_pos_feat",
          "attn_mask", "ex_weight", "txt_lens", "num_bbs")
TASK_KEYS = {"mlm": ("mlm_pos", "mlm_tgt"),
             "mrfr": ("img_masks", "mrm_pos", "mrm_valid", "feat_targets"),
             "mrckl": ("img_masks", "mrm_pos", "mrm_valid", "label_targets"),
             "itm": ("targets",)}


def tagged(cls):
    """``cls`` whose records carry (text id, image, ITM target, random
    stream state) and whose batches carry their rows' tags (a list, which
    the loop does not copy to the card)."""

    class Tagged(cls):
        def get_record(self, i, rng=None):
            state = rng.get_state() if rng is not None else None
            rec = super().get_record(i, rng)
            img = (self.train_imgs[i] if hasattr(self, "train_imgs")
                   else self.img_fnames[i])
            rec["_tag"] = (self.ids[i], img, rec.get("target"), state)
            return rec

        @staticmethod
        def collate(records, t_bucket, r_bucket, batch_size):
            batch = cls.collate(records, t_bucket, r_bucket, batch_size)
            batch["_tags"] = [r["_tag"] for r in records]
            return batch

    Tagged.__name__ = "Tagged" + cls.__name__
    return Tagged


def reference_model(ctx, device="meta"):
    drop = ctx.mix["recipe"]["dropout"]
    with torch.device(device):
        return RefModel(RefConfig.from_dict(
            ctx.cfg, hidden_dropout_prob=drop,
            attention_probs_dropout_prob=drop), "pretrain")


def run(ctx):
    from uniter_tpu_torch.data.datasets import ImageDbGroup
    from uniter_tpu_torch.data.itm import ItmDataset
    from uniter_tpu_torch.data.loader import BucketLoader, MetaLoader
    from uniter_tpu_torch.data.mlm import MlmDataset
    from uniter_tpu_torch.data.mrm import MrcDataset, MrfrDataset
    from uniter_tpu_torch.data.txt_db import TxtTokDb
    from uniter_tpu_torch.models.pretrain import UniterForPretraining
    from uniter_tpu_torch.training import driver
    from uniter_tpu_torch.training.loop import (MixedTaskLoop,
                                                pretrain_loss_units)
    from uniter_tpu_torch.training.optim import build_optimizer
    from uniter_tpu_torch.training.sched import get_lr_schedule
    from uniter_tpu_torch.training.step import TrainState, make_train_step

    mix, rc = ctx.mix, ctx.mix["recipe"]
    c = mix["corpus"]
    images = ImageCorpus(c["corpus_seed"], c["n_img"], c["regions"], True)
    img_path = write_image_db(ctx.dirs["corpus"], images, {
        k: c[k] for k in ("corpus_seed", "n_img", "regions")} | {"soft": 1})
    texts = TextCorpus(ctx.seeds.data, c["n_txt"], c["txt_len"], images,
                       prefix="c", layout_seed=c["layout_seed"])
    txt_path = write_text_db(os.path.join(ctx.dirs["corpus"], "txt-pretrain"),
                             texts)
    opts = opts_for(ctx, rc)
    group = ImageDbGroup(opts.conf_th, opts.max_bb, opts.min_bb, opts.num_bb)
    build = {"itm": lambda t, i: tagged(ItmDataset)(
                 t, i, neg_sample_p=rc["itm_neg_prob"]),
             "mlm": lambda t, i: tagged(MlmDataset)(t, i),
             "mrfr": lambda t, i: tagged(MrfrDataset)(rc["mrm_prob"], t, i),
             "mrckl": lambda t, i: tagged(MrcDataset)(rc["mrm_prob"], t, i)}
    loaders, itm_ds = {}, None
    for task, ratio in zip(rc["tasks"], rc["mix_ratio"]):
        ds = build[task](TxtTokDb(txt_path, max_txt_len=rc["max_txt_len"]),
                         group[img_path])
        if task == "itm":
            itm_ds = ds
        loaders[f"{task}_corpus"] = (BucketLoader(
            ds, driver.bucket_spec(opts, ds), collate=type(ds).collate,
            seed=c["order_seed"], loop=True, shuffle=True, drop_last=True,
            num_workers=rc["n_workers"], worker_type="thread"), ratio)
    meta = MetaLoader(loaders, accum_steps=1, seed=c["order_seed"])

    cfg = driver.model_config_from_opts(opts)
    ref_meta = reference_model(ctx)
    shapes, kinds = reference_shapes(ref_meta), init_kind(ref_meta)
    std = ctx.cfg["initializer_range"]
    on_cuda = torch.device(ctx.device).type == "cuda"
    with torch.device("meta"):
        model = UniterForPretraining(cfg, img_dim=2048, img_label_dim=1601,
                                     ot_impl="cuda" if on_cuda else "xla")
    model = model.to_empty(device=ctx.device)
    model.load_state_dict(make_params(shapes, kinds, ctx.seeds.weights,
                                      ctx.device, std))
    sched = get_lr_schedule(rc["lr"], rc["warmup_steps"],
                            rc["num_train_steps"])
    state = TrainState(step=0, model=model, opt=build_optimizer(
        model, sched, **driver.optim_kwargs(opts)))
    if ctx.fault == "stale":
        training.plant_stale(state)

    caps = training.Captures()
    n_check = mix["check"]["steps"]
    steps = {}

    def get_step(task):
        if task not in steps:
            lam = rc["itm_ot_lambda"] if task == "itm" else 0.0

            def loss_fn(m, batch, generator, _task=task, _lam=lam):
                if ctx.fault == "half_batch":
                    batch = half_rows(_task, batch)
                loss, metrics = m.scalar_loss(batch, _task, ot_lambda=_lam,
                                              deterministic=False,
                                              generator=generator)
                if len(caps.losses) < n_check:
                    caps.losses.append(loss.detach())
                return loss, metrics
            steps[task] = make_train_step(loss_fn, loss_scale="sum")
        return steps[task]

    def account(item):
        name, batch = item
        task = name.split("_")[0]
        return {**train_batch_work(task, batch, ctx.cfg), "task": task}

    warm = [(name, b) for name, (loader, _) in loaders.items()
            for b in loader.example_batches()]
    tap = FeedTap(meta, account, keep=n_check, warm=warm)
    initial = training.initial_params(shapes, kinds, ctx.seeds.weights,
                                      ctx.device, std)
    tasks = set(rc["tasks"])
    control, profiler = training.make_window(
        ctx, len(warm), caps, state, initial, n_check,
        task_of=lambda s: tap.items[s - 1]["task"], tasks=tasks,
        profile_want=lambda s: {tap.items[i - 1]["task"] for i in s} >= tasks,
        profile_steps=mix["window"]["profile_steps"])
    loop = MixedTaskLoop(
        meta=tap, get_step=get_step, state=state, device=ctx.device,
        num_train_steps=rc["num_train_steps"], valid_steps=0,
        log_steps=rc["log_steps"], validate_fn=None, saver=None,
        seed=ctx.seeds.loop, loss_units_fn=pretrain_loss_units,
        transfer_dtype=cfg.compute_dtype, lr_schedule=sched,
        preempt=control)
    try:
        loop.run()
    finally:
        for loader, _ in loaders.values():
            loader.close()
    e2e = training.end_to_end(ctx, control, tap)
    prog = training.program_numbers(caps)
    kept = tap.kept
    record = training.Record(control, tap, profiler)
    itm_ids, itm_imgs = list(itm_ds.ids), list(itm_ds.img_fnames)
    del loop, state, model, meta, loaders, itm_ds
    training.free()

    def check(control=False):
        return check_steps(ctx, kept, texts, images, (itm_ids, itm_imgs),
                           prog, control)

    return e2e, record, check


def half_rows(task, batch):
    """The fault ``half_batch``: the loss over the first half of the rows
    (the weights of the second half zeroed, so the mean is over the rest)."""
    b = dict(batch)
    half = b["input_ids"].shape[0] // 2
    for k, zero in (("ex_weight", 0), ("mrm_valid", 0)):
        if k in b:
            v = b[k].clone()
            v[half:] = zero
            b[k] = v
    if task == "mlm":
        v = b["mlm_tgt"].clone()
        v[half:] = -1
        b["mlm_tgt"] = v
    if task == "itm":
        v = b["targets"].clone()
        v[half:] = -1
        b["targets"] = v
    return b


def itm_pairs(ids, fnames, neg_p: float):
    """ITM's first-epoch pairing worked out again (the published
    ``ItmDataset.new_epoch`` on a RandomState seeded 0): text id -> (image,
    target)."""
    rs = np.random.RandomState(0)
    labels = (rs.random_sample(len(ids)) >= neg_p).astype(int)
    pool = sorted(set(fnames))
    out = {}
    for i, (tid, img) in enumerate(zip(ids, fnames)):
        if labels[i] == 0:
            neg = img
            while neg == img:
                neg = pool[int(rs.choice(len(pool), size=1, replace=False)[0])]
            img = neg
        out[tid] = (img, int(labels[i]))
    return out


def check_steps(ctx, kept, texts, images, itm_src, prog, control=False):
    from gpubench.reference.batches import pretrain_batch

    rc = ctx.mix["recipe"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pairs = itm_pairs(*itm_src, rc["itm_neg_prob"])
    mismatch, batches = 0, []
    for name, b in kept:
        task = name.split("_")[0]
        tags = list(b["_tags"])
        if task == "itm":
            want = [(tid, *pairs[tid], st) for tid, *_, st in tags]
            mismatch += sum(w[:3] != t[:3] for w, t in zip(want, tags))
            tags = want
        t_b, r_b = b["input_ids"].shape[1], b["img_feat"].shape[1]
        mine = pretrain_batch(task, tags, t_b, r_b, texts, images,
                              rc["mrm_prob"])
        mismatch += training.count_mismatch(b, mine,
                                            COMMON + TASK_KEYS[task])
        batches.append((task, {k: torch.from_numpy(v).to(ctx.device)
                               for k, v in mine.items()}))

    def steps(numerics):
        model = reference_model(ctx).to_empty(device=ctx.device)
        model.load_state_dict(make_params(
            reference_shapes(model), init_kind(model), ctx.seeds.weights,
            ctx.device, ctx.cfg["initializer_range"]))
        opt = RefAdamW(
            dict(model.named_parameters()),
            lr_fn=warmup_linear_lr(rc["lr"], rc["warmup_steps"],
                                   rc["num_train_steps"]),
            betas=tuple(rc["betas"]), weight_decay=rc["weight_decay"],
            grad_norm=rc["grad_norm"], decay=decays(model))
        fwd = Forward(model, numerics)
        out = training.reference_steps(
            model, lambda task, b, seeds: fwd.pretrain_loss(
                b, task, seeds, rc["itm_ot_lambda"]),
            batches, ctx.seeds.loop, opt)
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
