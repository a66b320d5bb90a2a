"""Kind ``score_itm``: retrieval scoring through the port's
``utils/itm_fast.py`` ``fast_score_matrix`` (the corpus embedded on the
card, (txt_tile x img_tile)-pair tiles, layers 0..L-2 through the trunk,
the last as ``BertLayerCLS``), on ``UniterForImageTextRetrieval`` with the
harness's weights, in the configuration's dtype with the inference kernel
policy. The corpus is held in memory behind the eval-dataset interface
the scorer reads (the root ``bench.py`` ``bench_retrieval``'s
``SimpleNamespace``, copied). Each call scores ``captions_per_call``
captions against every image; successive calls walk the captions. One
call warms up; the window runs calls until its seconds have passed and
the call in flight has finished."""

from __future__ import annotations

import types

import numpy as np
import torch

from gpubench import training
from gpubench.corpus import ImageCorpus, TextCorpus
from gpubench.harness import make_params, reference_shapes
from gpubench.reference.batches import joint_rows
from gpubench.reference.model import (Forward, Numerics, RefConfig, RefModel,
                                      init_kind)
from gpubench.tracing import SubWindowProfiler, WindowControl, reduce_trace
from gpubench.yardstick import score_call_work


def eval_view(texts, images, rows):
    """The eval-dataset interface over captions ``rows`` and every image."""
    feats = {}

    def get_img_feat(name):
        if name not in feats:
            f, p = images.feat_pos(name)
            feats[name] = (f, p, len(f))
        return feats[name]

    return types.SimpleNamespace(
        ids=[texts.ids[i] for i in rows], all_img_ids=list(images.names),
        txt_db=types.SimpleNamespace(combine_inputs=lambda ids: np.concatenate(
            [[101], np.asarray(ids, np.int32), [102]]).astype(np.int32)),
        img_db=types.SimpleNamespace(get_img_feat=get_img_feat),
        example=lambda i: {"input_ids": texts.tokens[rows[i]]})


def reference_model(ctx, device="meta"):
    with torch.device(device):
        return RefModel(RefConfig.from_dict(ctx.cfg), "itm")


def run(ctx):
    from uniter_tpu_torch.config import (UniterConfig,
                                         resolve_kernel_policies)
    from uniter_tpu_torch.models.itm import UniterForImageTextRetrieval
    from uniter_tpu_torch.utils.itm_fast import fast_score_matrix

    mix, rc = ctx.mix, ctx.mix["recipe"]
    c = mix["corpus"]
    images = ImageCorpus(c["corpus_seed"], c["n_img"], c["regions"], False)
    texts = TextCorpus(ctx.seeds.data, c["n_txt"], c["txt_len"], images,
                       prefix="t", layout_seed=c["layout_seed"])
    cfg = resolve_kernel_policies(UniterConfig.from_dict(
        ctx.cfg, dtype=rc["dtype"]), ctx.device, training=False)
    ref_meta = reference_model(ctx)
    shapes, kinds = reference_shapes(ref_meta), init_kind(ref_meta)
    with torch.device("meta"):
        model = UniterForImageTextRetrieval(cfg, img_dim=2048)
    model = model.to_empty(device=ctx.device)
    model.load_state_dict(make_params(
        shapes, kinds, ctx.seeds.weights, ctx.device,
        ctx.cfg["initializer_range"]))
    model.eval()
    per = rc["captions_per_call"]
    order = np.random.default_rng(c["order_seed"]).permutation(c["n_txt"])
    t_lens = np.asarray([len(x) + 2 for x in texts.tokens])
    r_lens = np.minimum(images.nbb, rc["img_bucket"])

    profiler = None
    if ctx.trace:
        profiler = SubWindowProfiler(ctx.device, ctx.seconds,
                                     ctx.dirs["trace"], 1)
        profiler.warm()

    control = WindowControl(ctx.device, ctx.seconds, 1, profiler=profiler)
    calls, work = [], []
    k = 0
    while True:
        rows = [int(order[(k * per + i) % len(order)]) for i in range(per)]
        k += 1
        mat, _ = fast_score_matrix(
            model, eval_view(texts, images, rows),
            rc["txt_bucket"], rc["img_bucket"], txt_tile=rc["txt_tile"],
            img_tile=rc["img_tile"], dtype=rc["dtype"])
        if ctx.fault == "half_batch":
            mat[:, mat.shape[1] // 2:] = 0.0
        calls.append((rows, mat))
        work.append(score_call_work(t_lens[rows], r_lens, ctx.cfg))
        if control.poll():
            break
    wall = control.t1 - control.t0
    window = calls[1:]
    e2e = {"score_pairs_per_s": sum(m.size for _, m in window) / wall,
           "setup_s": control.t0 - ctx.t_start}
    if torch.device(ctx.device).type == "cuda":
        e2e["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    record = types.SimpleNamespace(
        window_s=wall, steps=list(control.window_steps), work=work[1:],
        prof_work=[], profile=None)
    if profiler is not None and profiler.done:
        record.profile = reduce_trace(profiler.out, profiler.wall_s,
                                      len(profiler.steps))
        record.prof_work = [work[s - 1] for s in profiler.steps]
    del model
    training.free()
    pick = np.random.default_rng(ctx.seeds.data + 1).choice(
        len(window) * per, size=min(mix["check"]["captions"],
                                    len(window) * per), replace=False)
    sample = [(window[i // per][0][i % per], window[i // per][1][i % per])
              for i in sorted(pick)]

    def check(control=False):
        return check_scores(ctx, texts, images, sample, control)

    return e2e, record, check


def check_scores(ctx, texts, images, sample, control=False):
    """The reference's scores of the sampled captions against every image
    (float32, TF32 off, in blocks of pairs), compared with the program's:
    the widest gap over the spread (standard deviation) of the reference's
    scores."""
    rc = ctx.mix["recipe"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = reference_model(ctx).to_empty(device=ctx.device)
    model.load_state_dict(make_params(
        reference_shapes(model), init_kind(model), ctx.seeds.weights,
        ctx.device, ctx.cfg["initializer_range"]))

    def scores(numerics):
        fwd = Forward(model, numerics)
        out = []
        with torch.no_grad():
            for row, _ in sample:
                ids = texts.with_specials(row)
                for j0 in range(0, len(images), rc["check_block"]):
                    names = images.names[j0:j0 + rc["check_block"]]
                    b = joint_rows([(ids, n, None) for n in names],
                                   rc["txt_bucket"], rc["img_bucket"], images)
                    b = {k: torch.from_numpy(v).to(ctx.device)
                         for k, v in b.items()}
                    out.append(fwd.cls_scores(b, model.rank_output).cpu())
        return torch.cat(out).double().numpy()

    ref = scores(Numerics())
    prog = np.concatenate([m for _, m in sample]).astype(np.float64)
    spread = max(float(ref.std()), 1e-30)
    out = {"program": {"score_gap": float(np.abs(prog - ref).max()) / spread}}
    if control:
        low = scores(Numerics(fp8=True))
        out["control"] = {"score_gap": float(np.abs(low - ref).max()) / spread}
    del model
    training.free()
    return out
