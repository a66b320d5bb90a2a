"""The port's VCR slice against the JAX package, on the CPU (tiny config,
fp32, dropout off unless stated).

* The weight bridge for ``UniterForVisualCommonsenseReasoning`` equals JAX
  ``export_state_dict`` and loads with ``strict=True``; ``predict`` (the
  [B, 2] scores), column 1 (``compute_loss=False``) and the per-row loss to
  1e-5 with question / answer / rationale type ids 0 / 2 / 3; gradients
  against ``jax.grad`` to 1e-5 of each tensor's largest entry (+1e-6).
* The two surgeries of ``load_trunk_checkpoint`` (4 type rows from 2, row
  0 into rows 2 and 3; 81 word rows past the file's, left at init) equal
  the JAX driver's tensor for tensor from one ``.pt``; a checkpoint that
  already has the widened tables loads as it is; a table of another width
  raises ``ValueError``.
* ``VcrDataset`` (qa, qar), their ``ConcatDataset`` and ``VcrEvalDataset``
  (val, test) records and collates equal the JAX package's.
* Two train steps (mean loss over the real rows, 10x lr on ``vcr_``)
  match the JAX step.
* ``train_vcr --tasks qa,qar`` -> resume -> ``inf_vcr`` val and test on the
  CPU; on one JAX-written run directory the port's ``inf_vcr`` writes the
  root ``inf_vcr.py``'s ``results_val.json`` and submission CSV.
* The three VCR pretraining datasets' records and collates equal the JAX
  package's from one ``RandomState``; ``UniterForPretrainingForVCR``'s
  per-task losses and gradients match JAX; it refuses ``itm``.
* ``pretrain_vcr`` (mlm / mrfr / mrckl) trains, validates and resumes.
* Over two gloo processes ``train_vcr`` validates on every question (10)
  and ``inf_vcr`` at world 2 writes world 1's val and test files;
  ``pretrain_vcr`` trains and resumes.
"""

import csv
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
from uniter_tpu.models.vcr import UniterForVisualCommonsenseReasoning as JaxVcr
from uniter_tpu_torch import config as pconfig
from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
from uniter_tpu_torch.models.vcr import (
    NUM_SPECIAL_TOKENS, UniterForVisualCommonsenseReasoning)
from test_torch_parallel import run_cli

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
torch.set_num_threads(2)

IMG_DIM = 32
LABEL_DIM = 11
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               type_vocab_size=4)


def _batch(b=8, t=10, r=6, seed=0):
    """b candidate rows: question (type 0), answer (2) and for half the
    rows a rationale (3); ragged text and regions; binary targets; one
    padding row of weight 0."""
    rng = np.random.RandomState(seed)
    attn = np.ones((b, t + r), np.int32)
    types = np.zeros((b, t), np.int32)
    for i in range(b):
        tl = rng.randint(6, t + 1)
        attn[i, tl:t] = 0
        types[i, 3:tl] = 2
        if i % 2:
            types[i, tl - 2:tl] = 3
    attn[1, t + r - 2:] = 0
    return dict(
        input_ids=rng.randint(1, 500, (b, t)).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        txt_type_ids=types,
        img_feat=rng.randn(b, r, IMG_DIM).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=attn, targets=(np.arange(b) % 4 == 1).astype(np.int32),
        ex_weight=np.array([1.0] * (b - 1) + [0.0], np.float32))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _bridge(tree):
    return {k: torch.tensor(np.asarray(v, np.float32))
            for k, v in state_dict_from_jax_params(
                jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
            ).items()}


def _perturb(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, x.shape)).astype(
            np.float32), jax.tree.map(np.asarray, dict(params)))


def _jax_params(model, batch, seed=0):
    return _perturb(model.init({"params": jax.random.PRNGKey(seed)},
                               _jb(batch), False)["params"], seed + 1)


@pytest.fixture(scope="module")
def pair():
    batch = _batch()
    jmodel = JaxVcr(jax_tiny(**NO_DROP), img_dim=IMG_DIM)
    params = _jax_params(jmodel, batch)
    model = UniterForVisualCommonsenseReasoning(
        pconfig.tiny_config(**NO_DROP), img_dim=IMG_DIM)
    model.load_state_dict(_bridge(params), strict=True)
    return SimpleNamespace(batch=batch, jmodel=jmodel, params=params,
                           model=model)


def _check_grads(model, want_grads):
    for k, p in model.named_parameters():
        want = want_grads[k].numpy()
        got = (p.grad.numpy() if p.grad is not None
               else np.zeros_like(want))  # mask_embedding: unused
        np.testing.assert_allclose(
            got, want, atol=1e-5 * np.abs(want).max() + 1e-6, rtol=0,
            err_msg=k)


def test_bridge_scores_loss_and_grads_match_jax(pair):
    ours = state_dict_from_jax_params(pair.params)
    theirs = export_state_dict(pair.params)
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        assert np.array_equal(ours[k], np.asarray(v)), k
    assert sorted(ours) == sorted(pair.model.state_dict())
    jb, tb = _jb(pair.batch), _tt(pair.batch)
    var = {"params": pair.params}
    model = pair.model
    scores = model.predict(tb)
    assert scores.shape == (8, 2) and scores.dtype == torch.float32
    np.testing.assert_allclose(
        scores.detach().numpy(),
        np.asarray(pair.jmodel.apply(var, jb, method=JaxVcr.predict)),
        atol=1e-5, rtol=0)
    col1 = model(tb, False)
    assert col1.shape == (8, 1) and torch.equal(col1, scores[:, 1:])
    np.testing.assert_allclose(col1.detach().numpy(),
                               np.asarray(pair.jmodel.apply(var, jb, False)),
                               atol=1e-5, rtol=0)
    # the type ids reach the trunk: all-zero types change the scores
    plain = model.predict({**tb, "txt_type_ids": torch.zeros_like(
        tb["txt_type_ids"])})
    assert (plain - scores).abs().max() > 1e-4

    def jloss(p):
        per = pair.jmodel.apply({"params": p}, jb, True)
        return jnp.sum(per * jb["ex_weight"]) / jnp.sum(jb["ex_weight"])

    want_grads = _bridge(jax.grad(jloss)(
        jax.tree.map(jnp.asarray, pair.params)))
    model.zero_grad()
    loss = model(tb)
    np.testing.assert_allclose(loss.detach().numpy(),
                               np.asarray(pair.jmodel.apply(var, jb, True)),
                               atol=1e-5, rtol=0)
    from uniter_tpu_torch.train_vcr import vcr_loss

    model.train()
    vcr_loss(model, tb, None).backward()
    model.eval()
    _check_grads(model, want_grads)
    model.zero_grad()


def test_surgeries_match_jax_driver(tmp_path):
    """One 2-row, 300-word reference checkpoint into the 4-row, 381-word
    VCR trunk through both drivers, from the same initial values."""
    from uniter_tpu.training.driver import load_trunk_checkpoint as jax_load
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch.training.driver import load_trunk_checkpoint

    torch.manual_seed(0)
    src = UniterForVisualQuestionAnswering(
        pconfig.tiny_config(vocab_size=300), img_dim=IMG_DIM, num_answer=5)
    for p in src.parameters():
        torch.nn.init.normal_(p, 0.0, 0.1)
    sd = src.state_dict()
    path = str(tmp_path / "ref.pt")
    torch.save(sd, path)
    opts = SimpleNamespace(checkpoint=path)

    vocab = 300 + NUM_SPECIAL_TOKENS
    jcfg = jax_tiny(vocab_size=vocab, **NO_DROP)
    jmodel = JaxVcr(jcfg, img_dim=IMG_DIM)
    init = _jax_params(jmodel, _batch())
    kw = dict(n_type_rows=4, type_copy_row=0,
              n_special_words=NUM_SPECIAL_TOKENS)
    jparams = jax_load(jax.tree.map(np.copy, init), opts, jcfg, **kw)
    model = UniterForVisualCommonsenseReasoning(
        pconfig.tiny_config(vocab_size=vocab, **NO_DROP), img_dim=IMG_DIM)
    model.load_state_dict(_bridge(init), strict=True)
    load_trunk_checkpoint(model, opts, **kw)
    want = _bridge(jax.tree.map(np.asarray, jparams))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    tt = model.uniter.embeddings.token_type_embeddings.weight
    src_tt = sd["uniter.embeddings.token_type_embeddings.weight"]
    assert torch.equal(tt[:2], src_tt)
    assert torch.equal(tt[2], src_tt[0]) and torch.equal(tt[3], src_tt[0])
    words = model.uniter.embeddings.word_embeddings.weight
    init_words = _bridge(init)["uniter.embeddings.word_embeddings.weight"]
    assert torch.equal(words[:300],
                       sd["uniter.embeddings.word_embeddings.weight"])
    assert torch.equal(words[300:], init_words[300:])

    # a VCR-pretrained checkpoint already holds 4 x 381: unchanged
    widened = {"uniter." + k: v for k, v in model.uniter.state_dict().items()}
    widened["uniter.embeddings.word_embeddings.weight"] = torch.randn(
        vocab, 64)
    widened["uniter.embeddings.token_type_embeddings.weight"] = torch.randn(
        4, 64)
    torch.save(widened, path)
    fresh = UniterForVisualCommonsenseReasoning(
        pconfig.tiny_config(vocab_size=vocab, **NO_DROP), img_dim=IMG_DIM)
    load_trunk_checkpoint(fresh, opts, **kw)
    for k, v in fresh.uniter.state_dict().items():
        assert torch.equal(v, widened["uniter." + k]), k

    # another width still raises, with the surgery and without it
    widened["uniter.embeddings.word_embeddings.weight"] = torch.zeros(7, 32)
    torch.save(widened, path)
    with pytest.raises(ValueError, match="word_embeddings"):
        load_trunk_checkpoint(fresh, opts, **kw)
    with pytest.raises(ValueError, match="word_embeddings"):
        load_trunk_checkpoint(fresh, opts, n_type_rows=4, type_copy_row=0)


def test_train_steps_match_jax():
    from uniter_tpu.training import optim as jopt
    from uniter_tpu.training import sched as jsched
    from uniter_tpu.training.step import TrainState as JaxState
    from uniter_tpu.training.step import make_train_step as jax_step
    from uniter_tpu_torch.train_vcr import vcr_loss
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training import sched as psched
    from uniter_tpu_torch.training import step as pstep

    feed = [_batch(8, 10, 6, 0), _batch(8, 14, 5, 1)]
    jmodel = JaxVcr(jax_tiny(**NO_DROP), img_dim=IMG_DIM)
    params = _jax_params(jmodel, feed[0], seed=3)

    def jax_loss(p, batch, rng):
        per = jmodel.apply({"params": p}, batch, True, deterministic=False,
                           rngs={"dropout": rng})
        w = batch["ex_weight"]
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0), {}

    sched = (1e-4, 1, 4)  # the head's lr 1e-3 after the multiplier
    jp = jax.tree.map(jnp.asarray, params)
    jstate = JaxState.create(jp, jopt.build_optimizer(
        jp, jsched.get_lr_schedule(*sched), grad_norm=1.0, fused=True,
        lr_mul=10.0, lr_mul_paths=("vcr_",)))
    jstep = jax_step(jax_loss, loss_scale="sum", donate=False)
    model = UniterForVisualCommonsenseReasoning(
        pconfig.tiny_config(**NO_DROP), img_dim=IMG_DIM)
    model.load_state_dict(_bridge(params), strict=True)
    state = pstep.TrainState(step=0, model=model, opt=popt.build_optimizer(
        model, psched.get_lr_schedule(*sched), grad_norm=1.0, fused=True,
        lr_mul=10.0, lr_mul_paths=("vcr_",)))
    step = pstep.make_train_step(lambda m, b, g: (vcr_loss(m, b, g), {}))
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


# ------------------------------------------------ pretraining for VCR

def _pretrain_batch(b=4, t=10, r=6, seed=0):
    rng = np.random.RandomState(seed)
    batch = _batch(b, t, r, seed)
    soft = rng.rand(b, 2, LABEL_DIM).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    mlm_tgt = rng.randint(1, 500, (b, 3)).astype(np.int32)
    mlm_tgt[:, 2] = -1
    valid = np.ones((b, 2), np.float32)
    valid[0, 1] = 0
    img_masks = np.zeros((b, r), np.int32)
    img_masks[:, 0] = 1
    batch.update(
        img_masks=img_masks, mlm_pos=rng.randint(0, t, (b, 3)).astype(
            np.int32), mlm_tgt=mlm_tgt,
        mrm_pos=np.tile(np.array([0, 2], np.int32), (b, 1)), mrm_valid=valid,
        feat_targets=rng.randn(b, 2, IMG_DIM).astype(np.float32),
        label_targets=soft)
    del batch["targets"]
    return batch


@pytest.mark.parametrize("task", ["mlm", "mrfr", "mrc", "mrc-kl"])
def test_pretrain_vcr_task_losses_and_grads_match_jax(task):
    from uniter_tpu.models.pretrain import UniterForPretraining as JaxPre
    from uniter_tpu.models.pretrain_vcr import (
        UniterForPretrainingForVCR as JaxPreVcr)
    from uniter_tpu_torch.models.pretrain_vcr import (
        UniterForPretrainingForVCR)

    batch = _pretrain_batch()
    jb, tb = _jb(batch), _tt(batch)
    jmodel = JaxPreVcr(jax_tiny(**NO_DROP), img_dim=IMG_DIM,
                       img_label_dim=LABEL_DIM)
    params = _perturb(jmodel.init({"params": jax.random.PRNGKey(0)}, jb,
                                  method=JaxPre.init_all)["params"], 1)
    model = UniterForPretrainingForVCR(pconfig.tiny_config(**NO_DROP),
                                       img_dim=IMG_DIM,
                                       img_label_dim=LABEL_DIM)
    model.load_state_dict(_bridge(params), strict=True)
    want = jmodel.apply({"params": params}, jb, task, False,
                        deterministic=True)
    got = model(tb, task, False, deterministic=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)

    def jloss(p):
        return jmodel.apply({"params": p}, jb, task, deterministic=True,
                            method=JaxPre.scalar_loss)[0]

    jp = jax.tree.map(jnp.asarray, params)
    want_grads = _bridge(jax.grad(jloss)(jp))
    model.zero_grad()
    loss, metrics = model.scalar_loss(tb, task, deterministic=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jp)),
                               rtol=1e-4)
    assert set(metrics) == {task}
    loss.backward()
    for k, p in model.named_parameters():
        w = want_grads[k].numpy()
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(w)
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max() + 1e-6,
                                   rtol=0, err_msg=k)
    with pytest.raises(ValueError, match="ITM"):
        model(tb, "itm")
    with pytest.raises(ValueError, match="ITM"):
        model.scalar_loss(tb, "itm", deterministic=True)


# ------------------------------------------------------ data and the CLIs

MODEL_CFG = dict(vocab_size=281, hidden_size=48, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=96,
                 max_position_embeddings=64, type_vocab_size=2,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 hidden_act="gelu", initializer_range=0.02)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A ground-truth and a detected img DB of 4 images each and a VCR txt
    DB of 10 questions (4 answers, 4 rationales each) with its per-task
    ``id2len`` files, written with the port's writers."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.txt_db import write_txt_db

    root = tmp_path_factory.mktemp("torch_vcr")
    rng = np.random.RandomState(0)

    def img_db(subdir, names, gt):
        recs = {}
        for n in names:
            nbb = rng.randint(4, 8)
            recs[n] = dict(
                features=rng.randn(nbb, 2048).astype(np.float16),
                norm_bb=rng.rand(nbb, 6).astype(np.float16),
                conf=np.linspace(1, 0.3, nbb).astype(np.float16),
                soft_labels=rng.rand(nbb, 1601).astype(np.float16))
        if gt:
            write_img_db(str(root / subdir), recs, conf_th=-1, num_bb=100)
        else:
            write_img_db(str(root / subdir), recs, conf_th=0.2, max_bb=8,
                         min_bb=3)

    gt_names = [f"vcr_gt_{i}.npz" for i in range(4)]
    det_names = [f"vcr_det_{i}.npz" for i in range(4)]
    img_db("img_gt", gt_names, True)
    img_db("img_det", det_names, False)
    recs, id2len_qa, id2len_qar, t2i = {}, {}, {}, {}

    def ids(lo, hi):
        return [int(x) for x in rng.randint(110, 280, rng.randint(lo, hi))]

    for i in range(10):
        tid = f"vcr_{i}"
        q = ids(4, 9)
        ans = [ids(2, 6) for _ in range(4)]
        rat = [ids(3, 8) for _ in range(4)]
        pair = [gt_names[i % 4], det_names[(i + 1) % 4]]
        recs[tid] = dict(input_ids=q, input_ids_as=ans, input_ids_rs=rat,
                         qa_target=int(rng.randint(0, 4)),
                         qar_target=int(rng.randint(0, 4)), img_fname=pair)
        id2len_qa[tid] = len(q) + max(map(len, ans))
        id2len_qar[tid] = id2len_qa[tid] + max(map(len, rat))
        t2i[tid] = pair
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [104, 281]}
    write_txt_db(str(root / "txt"), recs, meta, t2i)
    for name, obj in (("id2len_qa", id2len_qa), ("id2len_qar", id2len_qar)):
        with open(root / "txt" / f"{name}.json", "w") as f:
            json.dump(obj, f)
    with open(root / "model.json", "w") as f:
        json.dump(MODEL_CFG, f)
    return root


def _img_dbs(dbs, cls):
    return dict(img_db_gt=cls(str(dbs / "img_gt"), conf_th=-1, max_bb=8,
                              min_bb=3, num_bb=100),
                img_db=cls(str(dbs / "img_det"), conf_th=0.2, max_bb=8,
                           min_bb=3))


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want


def _both(fn):
    """fn(data module, img DB class, spec_from_dataset, BucketLoader,
    datasets module) on the JAX package and on the port."""
    from uniter_tpu.data import buckets as jb
    from uniter_tpu.data import datasets as jd
    from uniter_tpu.data import img_db as ji
    from uniter_tpu.data import loader as jl
    from uniter_tpu.data import pretrain_vcr as jp
    from uniter_tpu.data import vcr as jv
    from uniter_tpu_torch.data import buckets as pb
    from uniter_tpu_torch.data import datasets as pd
    from uniter_tpu_torch.data import img_db as pi
    from uniter_tpu_torch.data import loader as pl
    from uniter_tpu_torch.data import pretrain_vcr as pp
    from uniter_tpu_torch.data import vcr as pv

    want = fn(SimpleNamespace(vcr=jv, pre=jp, img=ji.DetectFeatDb,
                              spec=jb.spec_from_dataset,
                              loader=jl.BucketLoader,
                              concat=jd.ConcatDataset))
    got = fn(SimpleNamespace(vcr=pv, pre=pp, img=pi.DetectFeatDb,
                             spec=pb.spec_from_dataset,
                             loader=pl.BucketLoader,
                             concat=pd.ConcatDataset))
    return got, want


@pytest.mark.parametrize("kind", ["qa", "qar", "qa,qar", "val", "test"])
def test_vcr_datasets_and_collates_match_jax(dbs, kind):
    def run(m):
        imgs = _img_dbs(dbs, m.img)
        if kind in ("val", "test"):
            ds = m.vcr.VcrEvalDataset(kind, m.vcr.VcrTxtTokDb(
                str(dbs / "txt"), max_txt_len=-1, task="qa,qar"), **imgs)
            collate = ds.collate_fn
        else:
            parts = [m.vcr.VcrDataset(m.vcr.VcrTxtTokDb(
                str(dbs / "txt"), max_txt_len=40, task=t), **imgs)
                for t in kind.split(",")]
            ds = parts[0] if len(parts) == 1 else m.concat(parts)
            collate = m.vcr.VcrDataset.collate
        recs = [ds.get_record(i, np.random.RandomState(i))
                for i in range(len(ds))]
        loader = m.loader(ds, m.spec(ds, 256), shuffle=kind == "qa,qar",
                          drop_last=False, seed=3, collate=collate)
        return len(ds), recs, list(loader)

    got, want = _both(run)
    assert got[0] == want[0] == (20 if kind == "qa,qar" else 10)
    _same(got[1], want[1])
    _same(got[2], want[2])
    rows = got[1][0]["rows"]
    types = np.concatenate([r["txt_type_ids"] for r in rows])
    assert set(np.unique(types)) <= {0, 2, 3}
    if kind in ("qar", "test"):
        assert 3 in types
    n = {"val": 8, "test": 20}.get(kind, 4)
    assert len(rows) == n


def test_token_range_checks_the_candidate_rows(dbs):
    """``check_token_range`` reads the rows of a VCR record: the DB's ids
    pass the widened config and fail one without the special words; type
    ids 2 and 3 fail a 2-row type table."""
    from uniter_tpu_torch.data.img_db import DetectFeatDb
    from uniter_tpu_torch.data.vcr import VcrDataset, VcrTxtTokDb
    from uniter_tpu_torch.training.driver import check_token_range

    ds = VcrDataset(VcrTxtTokDb(str(dbs / "txt"), max_txt_len=40,
                                task="qar"), **_img_dbs(dbs, DetectFeatDb))
    check_token_range(pconfig.tiny_config(vocab_size=281, type_vocab_size=4),
                      ds)
    with pytest.raises(ValueError, match="token id .* >= vocab_size 270"):
        check_token_range(pconfig.tiny_config(vocab_size=270,
                                              type_vocab_size=4), ds)
    with pytest.raises(ValueError, match="type id 3 >= type_vocab_size 2"):
        check_token_range(pconfig.tiny_config(vocab_size=281), ds)


@pytest.mark.parametrize("task", ["mlm", "mrfr", "mrc"])
def test_pretrain_vcr_datasets_match_jax(dbs, task):
    def run(m):
        txt = m.vcr.VcrTxtTokDb(str(dbs / "txt"), max_txt_len=60, task="qar")
        imgs = _img_dbs(dbs, m.img)
        if task == "mlm":
            ds = m.pre.MlmDatasetForVCR(txt, **imgs)
        elif task == "mrfr":
            ds = m.pre.MrfrDatasetForVCR(0.3, txt, **imgs)
        else:
            ds = m.pre.MrcDatasetForVCR(0.3, txt, **imgs)
        recs = [ds.get_record(i, np.random.RandomState(i))
                for i in range(len(ds))]
        return recs, list(m.loader(ds, m.spec(ds, 128), seed=2,
                                   collate=type(ds).collate))

    got, want = _both(run)
    _same(got, want)
    assert set(np.unique(got[0][0]["txt_type_ids"])) == {0, 2, 3}


def _run(args):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def _common(dbs, out):
    return dict(model_config=str(dbs / "model.json"), output_dir=str(out),
                max_bb=8, min_bb=3, n_workers=0, warmup_steps=2,
                log_steps=1, device="cpu")


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_train_vcr_cli_trains_resumes_and_infers(dbs):
    out = dbs / "run"
    conf = dict(_common(dbs, out), train_txt_db=str(dbs / "txt"),
                train_img_db=str(dbs / "img_det"),
                train_img_db_gt=str(dbs / "img_gt"),
                val_txt_db=str(dbs / "txt"),
                val_img_db=str(dbs / "img_det"),
                val_img_db_gt=str(dbs / "img_gt"), tasks="qa,qar",
                train_batch_size=256, val_batch_size=512, valid_steps=2,
                num_train_steps=3)
    path = str(dbs / "train.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    proc = _run(["-m", "uniter_tpu_torch.train_vcr", "--config", path])
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out / "log" / "model.json") as f:
        saved = json.load(f)
    # the run records the text vocabulary; the 81 special words are the
    # model's own
    assert saved["type_vocab_size"] == 4 and saved["vocab_size"] == 281
    weights = torch.load(out / "ckpt" / "model_step_3.pt", weights_only=True)
    assert weights["uniter.embeddings.word_embeddings.weight"].shape[0] == (
        281 + NUM_SPECIAL_TOKENS)
    val = {}
    for line in open(out / "log" / "scalars.jsonl"):
        rec = json.loads(line)
        val.setdefault(rec["step"], {}).update(
            {k: v for k, v in rec.items() if k.startswith("valid/")})
    val = [v for v in val.values() if v]
    assert val and all(v["valid/n_ex"] == 10 for v in val)
    assert all(0.0 <= v["valid/qar_joint_acc"] <= v["valid/qa_acc"] <= 1.0
               for v in val)
    proc = _run(["-m", "uniter_tpu_torch.train_vcr", "--config", path,
                 "--num_train_steps", "4"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed from step 3" in proc.stderr

    base = ["--txt_db", str(dbs / "txt"), "--img_db", str(dbs / "img_det"),
            "--img_db_gt", str(dbs / "img_gt"), "--train_dir", str(out),
            "--device", "cpu"]
    pred = dbs / "pred"
    proc = _run(["-m", "uniter_tpu_torch.inf_vcr", *base, "--split", "val",
                 "--output_dir", str(pred)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.load(open(pred / "results_val.json"))
    assert res["n_ex"] == 10
    proc = _run(["-m", "uniter_tpu_torch.inf_vcr", *base, "--split", "test",
                 "--output_dir", str(pred)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = _read_csv(pred / "test_submission.csv")
    assert rows[0][:2] == ["annot_id", "answer_0"] and len(rows[0]) == 21
    assert sorted(r[0] for r in rows[1:]) == sorted(
        f"vcr_{i}" for i in range(10))
    for r in rows[1:]:
        probs = np.asarray(r[1:], np.float64).reshape(5, 4)
        np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)


def test_port_inf_vcr_matches_jax(dbs):
    """One training directory as a JAX run writes it: the root
    ``inf_vcr.py`` and ``python -m uniter_tpu_torch.inf_vcr --device cpu``
    write the same results_val.json and, to 1e-5, the same submission."""
    import inf_vcr
    from uniter_tpu.config import UniterConfig
    from uniter_tpu.utils.save import save_params_msgpack

    train_dir = dbs / "jax_run"
    os.makedirs(train_dir / "log")
    os.makedirs(train_dir / "ckpt")
    with open(train_dir / "log" / "model.json", "w") as f:
        json.dump(dict(MODEL_CFG, type_vocab_size=4), f)
    with open(train_dir / "log" / "hps.json", "w") as f:
        json.dump(dict(conf_th=0.2, max_bb=8, min_bb=3, num_bb=36,
                       compressed_db=False, attention_impl="pallas"), f)
    cfg = UniterConfig.from_dict(
        dict(MODEL_CFG, vocab_size=281 + NUM_SPECIAL_TOKENS),
        dtype="float32", type_vocab_size=4)
    model = JaxVcr(cfg, img_dim=2048)
    dummy = dict(
        input_ids=np.ones((4, 8), np.int32),
        position_ids=np.tile(np.arange(8, dtype=np.int32), (4, 1)),
        txt_type_ids=np.zeros((4, 8), np.int32),
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
    for split in ("val", "test"):
        args = ["--txt_db", str(dbs / "txt"), "--img_db",
                str(dbs / "img_det"), "--img_db_gt", str(dbs / "img_gt"),
                "--train_dir", str(train_dir), "--batch_size", "512",
                "--split", split]
        jax_out = str(dbs / f"jax_pred_{split}")
        inf_vcr.main(inf_vcr.get_parser().parse_args(
            args + ["--output_dir", jax_out]))
        port_out = str(dbs / f"port_pred_{split}")
        proc = _run(["-m", "uniter_tpu_torch.inf_vcr", *args, "--output_dir",
                     port_out, "--device", "cpu"])
        assert proc.returncode == 0, proc.stderr[-3000:]
        if split == "val":
            want = json.load(open(os.path.join(jax_out, "results_val.json")))
            got = json.load(open(os.path.join(port_out, "results_val.json")))
            assert got == want and want["n_ex"] == 10
            continue
        want = _read_csv(os.path.join(jax_out, "test_submission.csv"))
        got = _read_csv(os.path.join(port_out, "test_submission.csv"))
        assert got[0] == want[0] and len(got) == len(want) == 11
        for g, w in zip(got[1:], want[1:]):
            assert g[0] == w[0]
            np.testing.assert_allclose(np.asarray(g[1:], np.float64),
                                       np.asarray(w[1:], np.float64),
                                       atol=1e-5, rtol=0)


def test_pretrain_vcr_cli_trains_and_resumes(dbs):
    out = dbs / "pretrain_run"
    task_cfg = [{"name": "vcr", "db": str(dbs / "txt"), "vcr_task": "qar",
                 "tasks": ["mlm", "mrfr", "mrckl"], "mix_ratio": [2, 1, 1]}]
    conf = dict(_common(dbs, out), train_img_db=str(dbs / "img_det"),
                train_img_db_gt=str(dbs / "img_gt"),
                train_datasets=task_cfg, val_datasets=task_cfg,
                train_batch_size=256, val_batch_size=512, valid_steps=3,
                num_train_steps=3, max_txt_len=60)
    path = str(dbs / "pretrain.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    proc = _run(["-m", "uniter_tpu_torch.pretrain_vcr", "--config", path])
    assert proc.returncode == 0, proc.stderr[-3000:]
    scalars = open(out / "log" / "scalars.jsonl").read()
    for key in ("valid/mlm_vcr_acc", "valid/mrfr_vcr_loss",
                "valid/mrckl_vcr_acc"):
        assert key in scalars, key
    proc = _run(["-m", "uniter_tpu_torch.pretrain_vcr", "--config", path,
                 "--num_train_steps", "5"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed from step 3" in proc.stderr
    assert "fast-forwarded task mix by 3 steps" in proc.stderr
    assert "model_step_5.pt" in os.listdir(out / "ckpt")


# ------------------------------------------------------ over two processes

def test_train_vcr_and_inf_vcr_over_two_processes(dbs):
    out = dbs / "run_two"
    conf = dict(_common(dbs, out), train_txt_db=str(dbs / "txt"),
                train_img_db=str(dbs / "img_det"),
                train_img_db_gt=str(dbs / "img_gt"),
                val_txt_db=str(dbs / "txt"),
                val_img_db=str(dbs / "img_det"),
                val_img_db_gt=str(dbs / "img_gt"), tasks="qa,qar",
                train_batch_size=256, val_batch_size=512, valid_steps=2,
                num_train_steps=3)
    path = str(dbs / "train_two.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    run_cli("train_vcr", ["--config", path])
    scalars = [json.loads(line) for line in open(out / "log" /
                                                 "scalars.jsonl")]
    assert [s["valid/n_ex"] for s in scalars if "valid/n_ex" in s] == [10]
    for split in ("val", "test"):
        files = []
        for world in (1, 2):
            ans = dbs / f"two_{split}{world}"
            run_cli("inf_vcr", ["--txt_db", str(dbs / "txt"), "--img_db",
                                str(dbs / "img_det"), "--img_db_gt",
                                str(dbs / "img_gt"), "--train_dir", str(out),
                                "--output_dir", str(ans), "--split", split,
                                "--device", "cpu"], world)
            files.append({f: open(ans / f).read()
                          for f in sorted(os.listdir(ans))})
        assert len(files[0]) == 1 and files[1] == files[0]


def test_pretrain_vcr_over_two_processes(dbs):
    out = dbs / "pretrain_two"
    task_cfg = [{"name": "vcr", "db": str(dbs / "txt"), "vcr_task": "qar",
                 "tasks": ["mlm", "mrfr", "mrckl"], "mix_ratio": [2, 1, 1]}]
    conf = dict(_common(dbs, out), train_img_db=str(dbs / "img_det"),
                train_img_db_gt=str(dbs / "img_gt"),
                train_datasets=task_cfg, val_datasets=task_cfg,
                train_batch_size=256, val_batch_size=512, valid_steps=3,
                num_train_steps=3, max_txt_len=60)
    path = str(dbs / "pretrain_two.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    run_cli("pretrain_vcr", ["--config", path])
    outs = run_cli("pretrain_vcr",
                   ["--config", path, "--num_train_steps", "5"])
    assert any("fast-forwarded task mix by 3 steps" in o for o in outs)
    assert "model_step_5.pt" in os.listdir(out / "ckpt")
