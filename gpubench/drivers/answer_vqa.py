"""Kind ``answer_vqa``: VQA serving of pixel images through the port's
``inf_vqa.answer_questions`` (``training/infer.py`` ``eval_batches``: the
``DevicePrefetcher`` uploads the next call while the card answers this
one) on ``models/beit3.py``'s ``Beit3ForVisualQuestionAnswering``, with
the harness's weights, in the mix's dtype with the inference kernels.

The corpus is held on the host: ``n_img`` uint8 RGB images of
``img_size`` px (``PixelCorpus``, a fixed function of the mix's
``corpus_seed``) and ``n_txt`` questions, ``questions_per_image`` in a row
on each image; their lengths (``txt_len``, bos and eos included, skewed
short) are the mix's ``layout_seed``'s, their words the run's. Each call
answers the next ``pairs_per_call`` questions, collated as the pixel
store's batches are (``data/pixel_db.py`` ``collate_beit3``: each image
once, text padded to the call's longest, a multiple of 8). The calls run
back to back in one ``answer_questions`` pass over an endless loader; the
window's clock is read as each call starts (the call before it has been
read back and answered), one call warms up, and the pass ends at the
first call that starts after the window's seconds.

The check: 8 pairs of the window's first call, their logits against the
reference's (``reference/beit3.py``, float32, TF32 off, ``check_block``
pairs at a time, the same padding): ``logit_gap``, the widest gap over the
spread (standard deviation) of the reference's logits. ``half_batch``
shifts the image index of the second half of each call's pairs by one
(the reference keeps the true images).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from gpubench import training
from gpubench.beit3_work import vqa_call_work
from gpubench.reference.beit3 import (Forward, RefBeit3Config, RefBeit3Vqa,
                                      init_params)
from gpubench.reference.model import Numerics
from gpubench.tracing import SubWindowProfiler, WindowControl, reduce_trace

BOS, PAD, EOS = 0, 1, 2
BLOCK = 60  # px: the side of an image's colour blocks


class PixelCorpus:
    """``n_img`` uint8 [3, size, size] images from ``seed``: an 8 x 8 grid
    of random colour blocks per image (values 0..215) plus one shared
    texture (0..40), so that images differ in what their patches hold."""

    def __init__(self, seed: int, n_img: int, size: int):
        rng = np.random.default_rng(seed)
        grid = -(-size // BLOCK)
        low = rng.integers(0, 216, (n_img, 3, grid, grid), dtype=np.uint8)
        tex = rng.integers(0, 41, (3, size, size), dtype=np.uint8)
        self.pixels = low.repeat(BLOCK, 2).repeat(BLOCK, 3)[..., :size, :size]
        self.pixels += tex
        self.names = [f"img_{j:06d}" for j in range(n_img)]
        self.index = {n: j for j, n in enumerate(self.names)}

    def get(self, name: str) -> np.ndarray:
        return self.pixels[self.index[name]]


class Questions:
    """``n_txt`` questions over ``images``, ``per_image`` in a row on each:
    lengths lo..hi (bos and eos included; lo + a geometric draw of mean 5,
    capped) from ``layout_seed``, words from ``seed``."""

    def __init__(self, seed: int, n_txt: int, lengths, images: PixelCorpus,
                 per_image: int, vocab: int, layout_seed: int):
        lo, hi = lengths
        layout = np.random.default_rng(layout_seed)
        rng = np.random.default_rng(seed)
        lens = lo + np.minimum(layout.geometric(1.0 / 6.0, n_txt) - 1,
                               hi - lo)
        self.records = []
        for i, n in enumerate(lens):
            words = rng.integers(EOS + 1, vocab, int(n) - 2)
            self.records.append({
                "input_ids": np.concatenate([[BOS], words, [EOS]]),
                "img": images.names[(i // per_image) % len(images.names)],
                "qid": f"q{i:06d}"})


def model_config(ctx, device):
    from uniter_tpu_torch.models.beit3 import (Beit3Config,
                                               resolve_beit3_policies)

    return resolve_beit3_policies(Beit3Config.from_dict(
        ctx.cfg, dtype=ctx.mix["recipe"]["dtype"]), device)


def reference_model(ctx, device="meta"):
    with torch.device(device):
        return RefBeit3Vqa(RefBeit3Config.from_dict(ctx.cfg),
                           ctx.mix["recipe"]["num_answer"])


class WindowClosed(Exception):
    pass


class Served:
    """The model as ``answer_questions`` sees it: ``predict`` polls the
    window before every call but the first (the call before has been read
    back by then), stops the pass once the window has closed, and keeps
    the logits of call ``keep``."""

    def __init__(self, model, control: WindowControl, keep: int):
        self.model, self.control, self.keep = model, control, keep
        self.calls = 0
        self.kept = None

    def predict(self, batch):
        if self.calls and self.control.poll():
            raise WindowClosed
        self.calls += 1
        out = self.model.predict(batch)
        if self.calls == self.keep:
            self.kept = out
        return out


def run(ctx):
    from uniter_tpu_torch.data.pixel_db import collate_beit3
    from uniter_tpu_torch.inf_vqa import answer_questions
    from uniter_tpu_torch.models.beit3 import Beit3ForVisualQuestionAnswering

    mix, rc, c = ctx.mix, ctx.mix["recipe"], ctx.mix["corpus"]
    images = PixelCorpus(c["corpus_seed"], c["n_img"], ctx.cfg["img_size"])
    questions = Questions(ctx.seeds.data, c["n_txt"], c["txt_len"], images,
                          c["questions_per_image"], ctx.cfg["vocab_size"],
                          c["layout_seed"])
    cfg = model_config(ctx, ctx.device)
    num_answer = rc["num_answer"]
    with torch.device("meta"):
        model = Beit3ForVisualQuestionAnswering(cfg, num_answer)
    model = model.to_empty(device=ctx.device)
    model.load_state_dict(init_params(reference_model(ctx), ctx.seeds.weights,
                                      ctx.device,
                                      ctx.cfg["initializer_range"]))
    model.eval()
    per, n_q = rc["pairs_per_call"], len(questions.records)
    label2ans = {i: f"a{i}" for i in range(num_answer)}
    calls = []

    def make_call(k):
        recs = [questions.records[(k * per + i) % n_q] for i in range(per)]
        batch = collate_beit3(recs, images.get, PAD)
        calls.append((recs, batch["input_ids"].shape[1]))
        if ctx.fault == "half_batch":
            idx = batch["img_index"]
            idx[per // 2:] = (idx[per // 2:] + 1) % len(batch["pixel_values"])
        return batch

    def loader():
        k = 0
        while True:
            yield make_call(k)
            k += 1

    profiler = None
    if ctx.trace:
        # two calls: the upload the second call's start sets off falls
        # inside the session whatever the threads' order
        profiler = SubWindowProfiler(ctx.device, ctx.seconds,
                                     ctx.dirs["trace"], 2)
        profiler.warm()
    control = WindowControl(ctx.device, ctx.seconds, 1, profiler=profiler)
    served = Served(model, control, keep=2)
    try:
        answer_questions(served, loader(), label2ans, ctx.device,
                         keep_logits=True, prefetch=rc["prefetch"])
    except WindowClosed:
        pass
    wall = control.t1 - control.t0
    work = [vqa_call_work([len(r["input_ids"]) for r in recs],
                          len({r["img"] for r in recs}), ctx.cfg, num_answer)
            for recs, _ in calls]
    window = list(control.window_steps)
    e2e = {"score_pairs_per_s": sum(work[s - 1]["pairs"] for s in window)
           / wall,
           "setup_s": control.t0 - ctx.t_start}
    if torch.device(ctx.device).type == "cuda":
        e2e["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    record = types.SimpleNamespace(
        window_s=wall, steps=window, work=[work[s - 1] for s in window],
        prof_work=[], profile=None)
    if profiler is not None and profiler.done:
        record.profile = reduce_trace(profiler.out, profiler.wall_s,
                                      len(profiler.steps))
        record.prof_work = [work[s - 1] for s in profiler.steps]
    recs, t_pad = calls[served.keep - 1]
    pick = np.sort(np.random.default_rng(ctx.seeds.data + 1).choice(
        per, size=min(mix["check"]["pairs"], per), replace=False))
    prog = served.kept[torch.as_tensor(pick, device=served.kept.device)]
    prog = prog.double().cpu().numpy()
    sample = [recs[i] for i in pick]
    del model, served
    training.free()

    def check(control=False):
        return check_logits(ctx, images, sample, t_pad, prog, control)

    return e2e, record, check


def pad_text(recs, t_pad):
    """The records' ids padded with ``PAD`` to ``t_pad`` (the call's
    width), and their key mask (1 on each real token)."""
    ids = np.full((len(recs), t_pad), PAD, np.int64)
    mask = np.zeros((len(recs), t_pad), np.int64)
    for i, r in enumerate(recs):
        ids[i, :len(r["input_ids"])] = r["input_ids"]
        mask[i, :len(r["input_ids"])] = 1
    return ids, mask


def check_logits(ctx, images, sample, t_pad, prog, control=False):
    """The reference's logits of the sampled pairs (float32, TF32 off, in
    blocks of ``check_block`` pairs, text padded to the call's ``t_pad``)
    against the program's: the widest gap over the spread of the
    reference's logits. The reference's inputs come from the records
    themselves (each pair its own image, the ids padded here), not from
    the port's collate, so a fault there shows in the gap."""
    rc = ctx.mix["recipe"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = reference_model(ctx).to_empty(device=ctx.device)
    model.load_state_dict(init_params(model, ctx.seeds.weights, ctx.device,
                                      ctx.cfg["initializer_range"]))

    def logits(numerics):
        fwd = Forward(model, numerics)
        out = []
        with torch.no_grad():
            for i in range(0, len(sample), rc["check_block"]):
                recs = sample[i:i + rc["check_block"]]
                px = np.stack([images.get(r["img"]) for r in recs])
                ids, mask = pad_text(recs, t_pad)
                out.append(fwd.logits(
                    torch.from_numpy(px).to(ctx.device),
                    torch.from_numpy(ids).to(ctx.device),
                    torch.from_numpy(mask).to(ctx.device)).cpu())
        return torch.cat(out).double().numpy()

    ref = logits(Numerics())
    spread = max(float(ref.std()), 1e-30)
    out = {"program": {"logit_gap": float(np.abs(prog - ref).max()) / spread}}
    if control:
        low = logits(Numerics(fp8=True))
        out["control"] = {"logit_gap": float(np.abs(low - ref).max())
                          / spread}
    del model
    training.free()
    return out
