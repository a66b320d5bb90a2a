"""The port's referring-expression slice against the JAX package, on the CPU
(tiny config, fp32, dropout off unless stated).

* The weight bridge for ``UniterForReferringExpressionComprehension`` at
  ``mlp`` 1 and 2 equals JAX ``export_state_dict`` and loads with
  ``strict=True``; region scores (with the -1e4 fill at non-objects) to
  1e-5.
* The ``cls`` loss to 1e-5 and its gradients against ``jax.grad`` to 1e-5 of
  each tensor's largest entry (+1e-6); the ``rank`` loss and its gradients
  against the JAX package's ``margin_ranking`` over the same negatives.
* ``sample_neg``'s rules: the hard negative is the argmax without the
  target; an easy one is never the target or padding and covers the valid
  regions; the hard share is ``hard_ratio`` within 0.02 over 20000 draws;
  one seed gives one draw.
* Two train steps under ``cls`` (summed loss, ``loss_scale="mean"``, 10x lr
  on ``re_``) match the JAX step: loss and gradient norm to rtol 1e-5,
  parameters to atol 1e-5.
* ``ReDataset`` (after ``new_epoch`` from one ``RandomState``) and
  ``ReEvalDataset`` (gt and detected features) records and collates equal
  the JAX package's; ``compute_iou`` equals JAX's.
* The saver's best export: written only on an improvement, cleared by a
  fresh run in a reused directory, its value carried across a resume.
* ``train_re`` (rank loss) -> resume -> ``inf_re --ckpt best`` on two
  splits, on the CPU; on one JAX-written run directory the port's
  ``inf_re`` reports the root ``inf_re.py``'s accuracy and boxes.
* Over two gloo processes ``train_re`` (rank loss) keeps its best export
  and resumes; ``inf_re --ckpt best`` at world 2 writes world 1's files.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uniter_tpu.config import tiny_config as jax_tiny
from uniter_tpu.models.checkpoint import export_state_dict
from uniter_tpu.models.re import (
    UniterForReferringExpressionComprehension as JaxRe)
from uniter_tpu_torch import config as pconfig
from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
from uniter_tpu_torch.models.re import (
    NEG_FILL, UniterForReferringExpressionComprehension, rank_loss,
    sample_neg)
from test_torch_parallel import run_cli

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
torch.set_num_threads(2)

IMG_DIM = 32
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _batch(b=4, t=8, r=6, seed=0):
    """Ragged text and regions (obj_masks True at padding regions), one
    collate padding row (weight 0)."""
    rng = np.random.RandomState(seed)
    attn = np.ones((b, t + r), np.int32)
    attn[0, t - 3:t] = 0
    attn[1, t + r - 2:] = 0
    attn[2, t + r - 4:] = 0
    return dict(
        input_ids=rng.randint(1, 500, (b, t)).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        img_feat=rng.randn(b, r, IMG_DIM).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=attn, obj_masks=~attn[:, t:].astype(bool),
        targets=np.array([0, 3, 1, 2][:b], np.int32),
        ex_weight=np.array([1.0] * (b - 1) + [0.0], np.float32))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _bridge(tree):
    return {k: torch.tensor(np.asarray(v, np.float32))
            for k, v in state_dict_from_jax_params(tree).items()}


def _jax_params(model, batch, seed=0):
    params = model.init({"params": jax.random.PRNGKey(seed),
                         "sampling": jax.random.PRNGKey(1)}, _jb(batch),
                        True)["params"]
    rng = np.random.RandomState(seed + 1)
    return jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, x.shape)).astype(
            np.float32), jax.tree.map(np.asarray, dict(params)))


@pytest.fixture(scope="module", params=[1, 2])
def pair(request):
    mlp = request.param
    batch = _batch()
    jmodel = JaxRe(jax_tiny(**NO_DROP), img_dim=IMG_DIM, mlp=mlp)
    params = _jax_params(jmodel, batch)
    model = UniterForReferringExpressionComprehension(
        pconfig.tiny_config(**NO_DROP), img_dim=IMG_DIM, mlp=mlp)
    model.load_state_dict(_bridge(params), strict=True)
    return SimpleNamespace(mlp=mlp, batch=batch, jmodel=jmodel,
                           params=params, model=model)


def test_bridge_and_scores_match_jax(pair):
    ours = state_dict_from_jax_params(pair.params)
    theirs = export_state_dict(pair.params)
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        assert np.array_equal(ours[k], np.asarray(v)), k
    assert sorted(ours) == sorted(pair.model.state_dict())
    want = pair.jmodel.apply({"params": pair.params}, _jb(pair.batch), False)
    got = pair.model(_tt(pair.batch), False)
    assert got.dtype == torch.float32 and got.shape == (4, 6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    masks = pair.batch["obj_masks"]
    assert masks.sum() == 6 and (got.detach().numpy()[masks] == NEG_FILL).all()
    # without obj_masks the fill comes from the attention mask
    no_masks = {k: v for k, v in pair.batch.items() if k != "obj_masks"}
    assert torch.equal(pair.model(_tt(no_masks), False), got)


def _check_grads(model, want_grads):
    for k, p in model.named_parameters():
        want = want_grads[k].numpy()
        got = (p.grad.numpy() if p.grad is not None
               else np.zeros_like(want))  # mask_embedding: unused
        np.testing.assert_allclose(
            got, want, atol=1e-5 * np.abs(want).max() + 1e-6, rtol=0,
            err_msg=k)


def test_cls_loss_and_grads_match_jax(pair):
    jb = _jb(pair.batch)
    want_loss = pair.jmodel.apply({"params": pair.params}, jb, True)

    def jloss(p):
        return jnp.sum(pair.jmodel.apply({"params": p}, jb, True)
                       * jb["ex_weight"])

    want_grads = _bridge(jax.grad(jloss)(
        jax.tree.map(jnp.asarray, pair.params)))
    model = pair.model
    model.zero_grad()
    tb = _tt(pair.batch)
    loss = model(tb)
    assert loss.shape == (4,)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               atol=1e-5, rtol=0)
    (loss * tb["ex_weight"]).sum().backward()
    _check_grads(model, want_grads)
    model.zero_grad()


def test_rank_loss_matches_jax_with_the_same_negatives(pair):
    """The JAX loss recomputed from its own scores and ``margin_ranking``
    over the negatives the port drew."""
    from uniter_tpu.models.losses import margin_ranking

    jb, tb = _jb(pair.batch), _tt(pair.batch)
    model = pair.model
    scores = model(tb, False)
    neg = sample_neg(scores.detach(), tb["targets"], tb["obj_masks"], 0.5,
                     torch.Generator().manual_seed(3))
    jneg = jnp.asarray(neg.numpy())

    def jloss(p, reduce=True):
        s = pair.jmodel.apply({"params": p}, jb, False)
        t = jb["targets"]
        pos = jax.nn.sigmoid(jnp.take_along_axis(s, t[:, None], 1)[:, 0])
        ng = jax.nn.sigmoid(jnp.take_along_axis(s, jneg[:, None], 1)[:, 0])
        per = margin_ranking(pos, ng, 0.2)
        return jnp.sum(per * jb["ex_weight"]) if reduce else per

    jp = jax.tree.map(jnp.asarray, pair.params)
    want = np.asarray(jloss(jp, reduce=False))
    assert (want > 0).any()
    want_grads = _bridge(jax.grad(jloss)(jp))
    model.zero_grad()
    per = rank_loss(model(tb, False), tb["targets"], neg, 0.2)
    np.testing.assert_allclose(per.detach().numpy(), want, atol=1e-5, rtol=0)
    (per * tb["ex_weight"]).sum().backward()
    _check_grads(model, want_grads)
    model.zero_grad()


def test_sample_neg_rules():
    rng = np.random.RandomState(0)
    b, n = 20000, 9
    targets = torch.from_numpy(rng.randint(0, 5, b))
    n_valid = np.maximum(rng.randint(2, n + 1, b), targets.numpy() + 2)
    masks = torch.from_numpy(np.arange(n)[None] >= n_valid[:, None])
    # the model's scores: -1e4 at the padding regions
    scores = torch.from_numpy(rng.randn(b, n).astype(np.float32)
                              ).masked_fill(masks, NEG_FILL)

    def draw(ratio, seed, s=scores, t=targets, m=masks):
        return sample_neg(s, t, m, ratio, torch.Generator().manual_seed(seed))

    hard = scores.masked_fill(
        torch.nn.functional.one_hot(targets, n).bool(),
        float("-inf")).argmax(-1)
    assert torch.equal(draw(1.0, 0), hard)
    easy = draw(0.0, 0)
    assert not (easy == targets).any()
    assert not masks.gather(1, easy[:, None]).any()
    # one seed, one draw; the same noise under every ratio, so where the
    # easy and the hard index differ the draw tells which one was taken
    mixed = draw(0.3, 0)
    assert torch.equal(draw(0.3, 0), mixed)
    assert not torch.equal(draw(0.3, 1), mixed)
    differ = easy != hard
    assert ((mixed == hard) | (mixed == easy)).all()
    share = float((mixed[differ] == hard[differ]).float().mean())
    assert abs(share - 0.3) < 0.02, share
    # easy: uniform over the valid regions other than the target
    one = draw(0.0, 1, scores[:1].expand(b, n), torch.full((b,), 2),
               torch.from_numpy(np.arange(n) >= 6)[None].expand(b, n))
    freq = np.bincount(one.numpy(), minlength=n) / b
    assert set(np.nonzero(freq)[0]) == {0, 1, 3, 4, 5}
    assert np.abs(freq[[0, 1, 3, 4, 5]] - 0.2).max() < 0.02, freq


def test_rank_loss_replays_its_negatives_from_the_step_generator():
    from uniter_tpu_torch.training.step import step_generator

    model = UniterForReferringExpressionComprehension(
        pconfig.tiny_config(**NO_DROP), img_dim=IMG_DIM, loss_type="rank",
        hard_ratio=0.5)
    tb = _tt(_batch())
    a = model(tb, True, generator=step_generator(7, 3))
    b = model(tb, True, generator=step_generator(7, 3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        model(tb, True)


def test_train_steps_match_jax():
    """Two ``cls`` steps: the loss summed over the real rows
    (train_re.py:195), ``loss_scale="mean"``, lr_mul 10 on ``re_``."""
    from uniter_tpu.training import optim as jopt
    from uniter_tpu.training import sched as jsched
    from uniter_tpu.training.step import TrainState as JaxState
    from uniter_tpu.training.step import make_train_step as jax_step
    from uniter_tpu_torch.train_re import re_loss
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training import sched as psched
    from uniter_tpu_torch.training import step as pstep

    feed = [_batch(4, 8, 6, 0), _batch(4, 12, 5, 1)]
    jmodel = JaxRe(jax_tiny(**NO_DROP), img_dim=IMG_DIM, mlp=2)
    params = _jax_params(jmodel, feed[0], seed=3)

    def jax_loss(p, batch, rng):
        per_ex = jmodel.apply({"params": p}, batch, True, deterministic=False,
                              rngs={"dropout": rng})
        return jnp.sum(per_ex * batch["ex_weight"]), {}

    # the head's lr is 1e-3 after the multiplier, as the other tasks'
    # step tests run theirs
    sched = (1e-4, 1, 4)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = JaxState.create(jp, jopt.build_optimizer(
        jp, jsched.get_lr_schedule(*sched), grad_norm=1.0, fused=True,
        lr_mul=10.0, lr_mul_paths=("re_",)))
    jstep = jax_step(jax_loss, loss_scale="mean", donate=False)
    model = UniterForReferringExpressionComprehension(
        pconfig.tiny_config(**NO_DROP), img_dim=IMG_DIM, mlp=2)
    model.load_state_dict(_bridge(params), strict=True)
    state = pstep.TrainState(step=0, model=model, opt=popt.build_optimizer(
        model, psched.get_lr_schedule(*sched), grad_norm=1.0, fused=True,
        lr_mul=10.0, lr_mul_paths=("re_",)))
    step = pstep.make_train_step(lambda m, b, g: (re_loss(m, b, g), {}),
                                 loss_scale="mean")
    for batch in feed:
        jstate, jm = jstep(jstate, _jb(batch), jax.random.PRNGKey(0))
        state, m = step(state, _tt(batch), 0)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    want = _bridge(jstate.params)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_compute_iou_matches_jax():
    from uniter_tpu.data.re import compute_iou as jax_iou
    from uniter_tpu_torch.data.re import compute_iou

    rng = np.random.RandomState(0)
    for _ in range(200):
        a, b = rng.randint(0, 60, 4) + [0, 0, 1, 1], rng.randint(0, 60, 4) + [
            0, 0, 1, 1]
        assert compute_iou(a, b) == jax_iou(a, b)
    assert compute_iou([0, 0, 10, 10], [0, 0, 10, 10]) == 1.0


# ------------------------------------------------- the saver's best export

def _tiny_state():
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training.step import TrainState

    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    return TrainState(step=0, model=model, opt=popt.build_optimizer(
        model, 1e-3, fused=True))


def test_best_export_written_only_on_improvement(tmp_path):
    from uniter_tpu_torch.training.loop import TrainLoop

    batches = [{"x": np.full((2, 3), i, np.float32),
                "input_ids": np.zeros((2, 1), np.int32)} for i in range(8)]
    values = iter([0.5, 0.3, 0.7, 0.6])
    seen = []

    def validate_fn(state, step):
        v = next(values)
        seen.append((step, v))
        return {"acc": v}

    from uniter_tpu_torch.utils.save import TrainStateSaver

    saver = TrainStateSaver(str(tmp_path))
    written = []
    save = saver.save

    def spy(step, state, seed=0, best_value=None, block=True):
        written.append((step, best_value))
        return save(step, state, seed, best_value=best_value, block=block)

    saver.save = spy
    loop = TrainLoop(
        loss_fn=lambda m, b, g: (m(b["x"]).square().mean(), {}),
        state=_tiny_state(), train_loader=batches, device="cpu",
        num_train_steps=8, valid_steps=2, log_steps=100,
        validate_fn=validate_fn, saver=saver, preempt=False,
        best_metric="acc")
    loop.run()
    assert written == [(2, 0.5), (4, None), (6, 0.7), (8, None)]
    assert saver.best_info() == {"step": 6, "value": 0.7}
    best = torch.load(os.path.join(saver.dir, "model_step_best.pt"),
                      weights_only=True)
    at6 = torch.load(os.path.join(saver.dir, "model_step_6.pt"),
                     weights_only=True)
    assert all(torch.equal(best[k], at6[k]) for k in at6)
    assert not [f for f in os.listdir(saver.dir) if f.endswith(".tmp")]
    saver.clear_best()
    assert saver.best_info() is None
    assert not os.path.exists(os.path.join(saver.dir, "model_step_best.pt"))


# ------------------------------------------------------ data and the CLIs

MODEL_CFG = dict(vocab_size=300, hidden_size=48, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=96,
                 max_position_embeddings=64, type_vocab_size=2,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 hidden_act="gelu", initializer_range=0.02)


def _write_re_txt(path, recs, refs, anns, images):
    from uniter_tpu_torch.data.txt_db import write_txt_db

    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [104, 300]}
    write_txt_db(str(path), recs, meta,
                 {k: r["img_fname"] for k, r in recs.items()})
    for name, obj in (("refs", refs), ("annotations", anns),
                      ("categories", [dict(id=1, name="obj")]),
                      ("images", images)):
        with open(os.path.join(str(path), f"{name}.json"), "w") as f:
            json.dump(obj, f)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """6 images (gt and detected features) and 24 expressions (2 refs per
    image, 2 sentences each) written with the port's writers; ``txt2``
    holds the refs of 3 of the images."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.re import det_fname, gt_fname

    root = tmp_path_factory.mktemp("torch_re")
    rng = np.random.RandomState(0)
    imgs, images, anns = {}, [], []
    for i in range(6):
        iid = 1000 + i
        nbb = rng.randint(4, 9)
        for fname, n in ((gt_fname(iid), nbb),
                         (det_fname(iid), rng.randint(5, 10))):
            imgs[fname] = dict(
                features=rng.randn(n, 2048).astype(np.float16),
                norm_bb=rng.rand(n, 6).astype(np.float16),
                conf=np.ones(n, np.float16),
                soft_labels=rng.rand(n, 1601).astype(np.float16))
        ann_ids = [iid * 10 + k for k in range(nbb)]
        images.append(dict(id=iid, file_name=f"{iid}.jpg", ann_ids=ann_ids,
                           height=480, width=640))
        bb = imgs[gt_fname(iid)]["norm_bb"].astype(np.float32)
        for k, a in enumerate(ann_ids):
            box = [float(bb[k, 0] * 640), float(bb[k, 1] * 480),
                   float(bb[k, 4] * 640), float(bb[k, 5] * 480)]
            anns.append(dict(id=a, area=100, bbox=box, image_id=iid,
                             category_id=1, iscrowd=0))
    write_img_db(str(root / "img"), imgs, conf_th=0.2, max_bb=10, min_bb=1)
    by_id = {a["id"]: a for a in anns}
    recs, refs, sid = {}, [], 0
    for img in images:
        for _ in range(2):
            ann_id = img["ann_ids"][rng.randint(len(img["ann_ids"]))]
            sents = []
            for _ in range(2):
                recs[str(sid)] = dict(
                    sent_id=sid, sent="", ref_id=len(refs), ann_id=ann_id,
                    image_id=img["id"], bbox=by_id[ann_id]["bbox"],
                    input_ids=[int(x) for x in rng.randint(
                        110, 300, rng.randint(3, 12))],
                    img_fname=gt_fname(img["id"]))
                sents.append(sid)
                sid += 1
            refs.append(dict(ref_id=len(refs), ann_id=ann_id,
                             image_id=img["id"], split="train",
                             sent_ids=sents, sentences=[]))
    _write_re_txt(root / "txt", recs, refs, anns, images)
    keep = {im["id"] for im in images[:3]}
    _write_re_txt(root / "txt2",
                  {k: r for k, r in recs.items() if r["image_id"] in keep},
                  [r for r in refs if r["image_id"] in keep],
                  [a for a in anns if a["image_id"] in keep],
                  [im for im in images if im["id"] in keep])
    with open(root / "model.json", "w") as f:
        json.dump(MODEL_CFG, f)
    return root


def _same_batches(got, want):
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype and np.array_equal(g[k], v), k
            elif k in ("tgt_box", "obj_boxes"):
                assert len(g[k]) == len(v)
                for a, b in zip(g[k], v):
                    assert a.dtype == b.dtype and np.array_equal(a, b), k
            else:
                assert g[k] == v, k


@pytest.mark.parametrize("kind", ["train", "eval-gt", "eval-det"])
def test_datasets_and_collates_match_jax(dbs, kind):
    from uniter_tpu.data import re as jre
    from uniter_tpu.data.buckets import spec_from_dataset as jspec
    from uniter_tpu.data.img_db import DetectFeatDb as JImg
    from uniter_tpu.data.loader import BucketLoader as JLoader
    from uniter_tpu_torch.data import re as pre
    from uniter_tpu_torch.data.buckets import spec_from_dataset
    from uniter_tpu_torch.data.img_db import DetectFeatDb
    from uniter_tpu_torch.data.loader import BucketLoader

    def batches(mod, img, spec, loader):
        txt = mod.ReTxtTokDb(str(dbs / "txt"),
                             max_txt_len=10 if kind == "train" else -1)
        img_db = img(str(dbs / "img"), conf_th=0.2, max_bb=10, min_bb=1)
        if kind == "train":
            ds = mod.ReDataset(txt, img_db)
            ds.new_epoch(np.random.RandomState(5))
        else:
            ds = mod.ReEvalDataset(txt, img_db,
                                   use_gt_feat=kind == "eval-gt")
        recs = [ds.get_record(i, np.random.RandomState(i))
                for i in range(len(ds))]
        return ds.ids, recs, list(loader(ds, spec(ds, 64), shuffle=False,
                                         drop_last=False))

    jids, jrecs, want = batches(jre, JImg, jspec, JLoader)
    pids, precs, got = batches(pre, DetectFeatDb, spec_from_dataset,
                               BucketLoader)
    assert pids == jids
    # max_txt_len 10 leaves some expressions out of training
    assert (0 < len(pids) < 24) if kind == "train" else len(pids) == 24
    for g, w in zip(precs, jrecs):
        assert g.keys() == w.keys()
        for k, v in w.items():
            assert np.array_equal(np.asarray(g[k]), np.asarray(v)), k
    _same_batches(got, want)


def _run(args):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_re_cli_best_resume_and_inf_re(dbs):
    """``train_re`` (rank loss, validation every 2 steps) writes the best
    export with its sidecar; a resume keeps the best value; ``inf_re
    --ckpt best`` scores two splits; a fresh run in the reused directory
    clears the stale export before it validates."""
    out = dbs / "run"
    conf = dict(train_txt_db=str(dbs / "txt"), train_img_db=str(dbs / "img"),
                val_txt_db=str(dbs / "txt"), val_img_db=str(dbs / "img"),
                model_config=str(dbs / "model.json"), output_dir=str(out),
                train_batch_size=128, val_batch_size=256, max_bb=10,
                min_bb=1, n_workers=0, warmup_steps=2, valid_steps=2,
                log_steps=1, num_train_steps=4, device="cpu",
                train_loss="rank", mlp=2)
    path = str(dbs / "train.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    proc = _run(["-m", "uniter_tpu_torch.train_re", "--config", path])
    assert proc.returncode == 0, proc.stderr[-3000:]
    ckpt = out / "ckpt"
    assert {"model_step_2.pt", "model_step_4.pt", "model_step_best.pt",
            "model_step_best.json"} <= set(os.listdir(ckpt))

    def accs():
        return [(s["step"], s["valid/acc"]) for s in map(
            json.loads, open(out / "log" / "scalars.jsonl"))
            if "valid/acc" in s]

    def check_best():
        info = json.load(open(ckpt / "model_step_best.json"))
        a = accs()
        best = max(v for _, v in a)
        # the first step that reached the maximum
        assert info == {"step": min(s for s, v in a if v == best),
                        "value": best}, (info, a)
        return info

    check_best()
    # a resume starts from the saved best value: with the sidecar at an
    # accuracy no validation can beat, the resumed run writes no best
    with open(ckpt / "model_step_best.json", "w") as f:
        json.dump({"step": 4, "value": 1.0}, f)
    best_before = torch.load(ckpt / "model_step_best.pt", weights_only=True)
    proc = _run(["-m", "uniter_tpu_torch.train_re", "--config", path,
                 "--num_train_steps", "8"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed from step 4" in proc.stderr
    assert "new best checkpoint" not in proc.stderr
    assert json.load(open(ckpt / "model_step_best.json")) == {"step": 4,
                                                             "value": 1.0}
    best_after = torch.load(ckpt / "model_step_best.pt", weights_only=True)
    assert all(torch.equal(best_after[k], v) for k, v in best_before.items())
    assert len(accs()) == 4  # validated at 2, 4, 6 and 8

    pred = dbs / "pred"
    proc = _run(["-m", "uniter_tpu_torch.inf_re", "--txt_db",
                 f"{dbs / 'txt'}:{dbs / 'txt2'}", "--img_db",
                 str(dbs / "img"), "--train_dir", str(out), "--output_dir",
                 str(pred), "--use_gt_feat", "--ckpt", "best", "--device",
                 "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    r1 = json.load(open(pred / "results_txt_gt.json"))
    r2 = json.load(open(pred / "results_txt2_gt.json"))
    assert r1["n_ex"] == 24 and r2["n_ex"] == 12
    assert len(r1["predictions"]) == 24 and 0.0 <= r1["acc"] <= 1.0

    # a fresh run (no train state) into the same directory, never
    # validating: the stale best export goes first
    for f in os.listdir(ckpt):
        if f.startswith("train_state_"):
            os.remove(ckpt / f)
    proc = _run(["-m", "uniter_tpu_torch.train_re", "--config", path,
                 "--num_train_steps", "1", "--valid_steps", "100"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "cleared stale best export" in proc.stderr
    assert not {"model_step_best.pt", "model_step_best.json"} & set(
        os.listdir(ckpt))
    proc = _run(["-m", "uniter_tpu_torch.inf_re", "--txt_db",
                 str(dbs / "txt"), "--img_db", str(dbs / "img"),
                 "--train_dir", str(out), "--output_dir", str(pred),
                 "--ckpt", "best", "--device", "cpu"])
    assert proc.returncode != 0 and "does not exist" in proc.stderr


def test_port_inf_re_matches_jax(dbs):
    """One training directory as a JAX run writes it (hps.json with
    ``attention_impl="pallas"``, model.json, a msgpack snapshot at step 3
    and the best export): the root ``inf_re.py`` and ``python -m
    uniter_tpu_torch.inf_re --device cpu`` report the same accuracy and
    boxes, on detected and gt features."""
    import inf_re
    from uniter_tpu.config import UniterConfig
    from uniter_tpu.utils.save import save_params_msgpack

    train_dir = dbs / "jax_run"
    os.makedirs(train_dir / "log")
    os.makedirs(train_dir / "ckpt")
    with open(train_dir / "log" / "model.json", "w") as f:
        json.dump(MODEL_CFG, f)
    with open(train_dir / "log" / "hps.json", "w") as f:
        json.dump(dict(train_loss="cls", mlp=1, conf_th=0.2, max_bb=10,
                       min_bb=1, num_bb=36, compressed_db=False,
                       attention_impl="pallas"), f)
    cfg = UniterConfig.from_dict(MODEL_CFG, dtype="float32")
    model = JaxRe(cfg, img_dim=2048, mlp=1)
    dummy = dict(
        input_ids=np.ones((4, 8), np.int32),
        position_ids=np.tile(np.arange(8, dtype=np.int32), (4, 1)),
        img_feat=np.zeros((4, 6, 2048), np.float32),
        img_pos_feat=np.zeros((4, 6, 7), np.float32),
        attn_mask=np.ones((4, 14), np.int32))
    params = model.init({"params": jax.random.PRNGKey(1)}, dummy,
                        False)["params"]
    rng = np.random.RandomState(2)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.1, x.shape)).astype(
            np.float32), jax.tree.map(np.asarray, dict(params)))
    save_params_msgpack(str(train_dir / "ckpt" / "model_step_3.msgpack"),
                        params)
    save_params_msgpack(str(train_dir / "ckpt" / "model_step_best.msgpack"),
                        params)
    for feat in ([], ["--use_gt_feat"]):
        args = ["--txt_db", str(dbs / "txt"), "--img_db", str(dbs / "img"),
                "--train_dir", str(train_dir), "--batch_size", "256",
                "--ckpt", "best", *feat]
        jax_out = str(dbs / f"jax_pred{len(feat)}")
        inf_re.main(inf_re.get_parser().parse_args(
            args + ["--output_dir", jax_out]))
        port_out = str(dbs / f"port_pred{len(feat)}")
        proc = _run(["-m", "uniter_tpu_torch.inf_re", *args, "--output_dir",
                     port_out, "--device", "cpu"])
        assert proc.returncode == 0, proc.stderr[-3000:]
        name = "results_gt.json" if feat else "results_det.json"
        want = json.load(open(os.path.join(jax_out, name)))
        got = json.load(open(os.path.join(port_out, name)))
        assert want["n_ex"] == got["n_ex"] == 24
        assert got["acc"] == want["acc"]
        assert [p["sent_id"] for p in got["predictions"]] == [
            p["sent_id"] for p in want["predictions"]]
        for g, w in zip(got["predictions"], want["predictions"]):
            np.testing.assert_allclose(g["pred_box"], w["pred_box"],
                                       rtol=1e-6)
            assert abs(g["iou"] - w["iou"]) < 1e-6


# ------------------------------------------------------ over two processes

def test_train_re_and_inf_re_over_two_processes(dbs):
    out = dbs / "run_two"
    conf = dict(train_txt_db=str(dbs / "txt"), train_img_db=str(dbs / "img"),
                val_txt_db=str(dbs / "txt"), val_img_db=str(dbs / "img"),
                model_config=str(dbs / "model.json"), output_dir=str(out),
                train_batch_size=128, val_batch_size=256, max_bb=10,
                min_bb=1, n_workers=0, warmup_steps=2, valid_steps=2,
                log_steps=1, num_train_steps=4, device="cpu",
                train_loss="rank", mlp=2)
    path = str(dbs / "train_two.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    run_cli("train_re", ["--config", path])
    assert "model_step_best.json" in os.listdir(out / "ckpt")
    outs = run_cli("train_re", ["--config", path, "--num_train_steps", "6"])
    assert any("resumed from step 4" in o for o in outs)
    files = []
    for world in (1, 2):
        ans = dbs / f"two_ans{world}"
        run_cli("inf_re", ["--txt_db", f"{dbs / 'txt'}:{dbs / 'txt'}",
                           "--img_db", str(dbs / "img"), "--train_dir",
                           str(out), "--ckpt", "best", "--use_gt_feat",
                           "--output_dir", str(ans), "--device", "cpu"], world)
        files.append({f: json.load(open(ans / f))
                      for f in sorted(os.listdir(ans))})
    assert len(files[0]) == 2 and files[1] == files[0]
