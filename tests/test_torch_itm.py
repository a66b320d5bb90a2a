"""The port's image-text retrieval slice against the JAX package, on the CPU
(tiny config, fp32, dropout off unless stated).

* ``BertLayerCLS`` equals row 0 of ``BertLayer`` and the JAX
  ``BertLayerCLS`` to 1e-5.
* The retrieval model: the weight bridge loads with ``strict=True``; rank
  scores and the triplet loss to 1e-5, parameter gradients against
  ``jax.grad`` to 1e-5 of each tensor's largest entry (+1e-6): fp32
  rounding of another summation order through two layers.
* Two train steps of ``train_itm``'s loss match the JAX train step: loss
  and gradient norm to rtol 1e-5, parameters to atol 1e-5.
* The hard-negative model mines the same candidates as the JAX one (random
  fp32 scores have no ties, so ``torch.topk`` and ``lax.top_k`` agree on
  the order) and gives its loss to 1e-5.
* The datasets' records and collates (rank groups, both hard-negative
  streams, validation windows, evaluation minibatches) equal the JAX
  package's bit for bit from the same ``RandomState``.
* ``fast_score_matrix`` and ``fast_windowed_scores`` equal the JAX ones and
  the per-text minibatch scorer to 1e-5, with and without the CLS-only last
  layer, and ``itm_eval`` gives the same recalls.
* The CLIs: ``train_itm`` trains, validates, saves and resumes;
  ``inf_itm`` scores from its run directory and zero-shot from a ``.pt``
  written with the JAX ``export_state_dict``, as the root ``inf_itm.py``
  does; ``train_itm_hard_negatives`` trains and resumes with its mining
  streams fast-forwarded.
* Over two gloo processes: ``train_itm`` trains and validates; ``inf_itm``
  at world 2 writes world 1's ``score_matrix.npz`` (1e-3, fp16 on disk)
  and ``results.json``, fast and batched; ``train_itm_hard_negatives``
  splits each step's candidate batches over the ranks and resumes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uniter_tpu.config import UniterConfig as JaxConfig
from uniter_tpu.config import tiny_config as jax_tiny
from uniter_tpu.models import itm as jitm
from uniter_tpu_torch import config as pconfig
from uniter_tpu_torch.models import itm as pitm
from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
from test_torch_parallel import run_cli

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
torch.set_num_threads(2)

IMG_DIM = 32
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _batch(rows, t=8, r=6, seed=0, pad_last=0):
    rng = np.random.RandomState(seed)
    attn = np.ones((rows, t + r), np.int32)
    attn[0, t - 3:t] = 0
    attn[1, t + r - 2:] = 0
    w = np.ones(rows, np.float32)
    if pad_last:
        w[-pad_last:] = 0.0
    return dict(
        input_ids=rng.randint(1, 500, (rows, t)).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (rows, 1)),
        img_feat=rng.randn(rows, r, IMG_DIM).astype(np.float32),
        img_pos_feat=rng.rand(rows, r, 7).astype(np.float32),
        attn_mask=attn, ex_weight=w)


def _perturbed(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)).astype(
            np.float32), jax.tree.map(np.asarray, dict(tree)))


def _jax_params(model, batch, seed=0):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return _perturbed(model.init({"params": jax.random.PRNGKey(seed)}, jb,
                                 False)["params"], seed + 1)


def _bridge(tree):
    return {k: torch.tensor(np.asarray(v, np.float32))
            for k, v in state_dict_from_jax_params(tree).items()}


def _tt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_cls_layer_matches_full_layer_and_jax():
    from uniter_tpu.models.encoder import BertLayerCLS as JCls
    from uniter_tpu.models.encoder import attn_bias as jbias
    from uniter_tpu_torch.models.checkpoint import _LAYER_MAP, _convert
    from uniter_tpu_torch.models.encoder import (
        BertLayer, BertLayerCLS, attn_bias)

    rng = np.random.RandomState(3)
    hidden = rng.randn(3, 10, 64).astype(np.float32)
    mask = np.ones((3, 10), np.int32)
    mask[0, 6:] = 0
    mask[2, 2:] = 0
    jcls = JCls(jax_tiny(**NO_DROP))
    jp = _perturbed(jcls.init({"params": jax.random.PRNGKey(0)},
                              jnp.asarray(hidden),
                              jbias(jnp.asarray(mask)))["params"], 4)
    want = np.asarray(jcls.apply({"params": jp}, jnp.asarray(hidden),
                                 jbias(jnp.asarray(mask))))
    flat = {f"{a}/{b}/{c}" if c else f"{a}/{b}": v
            for a, sub in jp.items()
            for b, leaf in (sub.items() if isinstance(sub, dict) else [])
            for c, v in (leaf.items() if isinstance(leaf, dict)
                         else [(None, leaf)])}
    sd = {_LAYER_MAP[k][0]: torch.tensor(_convert(v, _LAYER_MAP[k][1]))
          for k, v in flat.items()}
    for ffn_impl in ("xla", "cuda"):
        cfg = pconfig.tiny_config(ffn_impl=ffn_impl, **NO_DROP)
        full, cls = BertLayer(cfg), BertLayerCLS(cfg)
        full.load_state_dict(sd, strict=True)
        cls.load_state_dict(sd, strict=True)
        assert not cls.fused_ffn  # the one row keeps the plain FFN
        th, tb = torch.from_numpy(hidden), attn_bias(torch.from_numpy(mask))
        got = cls(th, tb)
        assert got.shape == (3, 1, 64)
        np.testing.assert_allclose(got.detach().numpy(),
                                   full(th, tb)[:, :1].detach().numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                                   rtol=0)


@pytest.fixture(scope="module")
def pair():
    batch = _batch(9, pad_last=3)  # 3 groups of 3, the last one padding
    jmodel = jitm.UniterForImageTextRetrieval(jax_tiny(**NO_DROP),
                                              img_dim=IMG_DIM)
    params = _jax_params(jmodel, batch)
    model = pitm.UniterForImageTextRetrieval(pconfig.tiny_config(**NO_DROP),
                                             img_dim=IMG_DIM)
    model.load_state_dict(_bridge(params), strict=True)
    return batch, jmodel, params, model


def test_scores_loss_and_grads_match_jax(pair):
    batch, jmodel, params, model = pair
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_scores = np.asarray(jmodel.apply({"params": params}, jb, False))
    want_loss = np.asarray(jmodel.apply({"params": params}, jb, True,
                                        sample_size=3))
    want_grads = _bridge(jax.grad(lambda p: jnp.mean(jmodel.apply(
        {"params": p}, jb, True, sample_size=3)))(
        jax.tree.map(jnp.asarray, params)))
    model.zero_grad()
    tb = _tt(batch)
    scores = model(tb, False)
    loss = model(tb, True, sample_size=3)
    assert scores.shape == (9, 1) and loss.shape == (3, 2)
    np.testing.assert_allclose(scores.detach().numpy(), want_scores,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, atol=1e-5,
                               rtol=0)
    loss.mean().backward()
    for k, p in model.named_parameters():
        want = want_grads[k].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(
            got, want, atol=1e-5 * np.abs(want).max() + 1e-6, rtol=0,
            err_msg=k)


def test_train_steps_match_jax(pair):
    """Two steps of ``train_itm``'s loss (groups of 3, the padded group
    weighing 0), dropout 0, ``loss_scale="sum"``."""
    from uniter_tpu.training import optim as jopt
    from uniter_tpu.training import sched as jsched
    from uniter_tpu.training.step import TrainState as JaxState
    from uniter_tpu.training.step import make_train_step as jax_step
    from uniter_tpu_torch.train_itm import rank_loss
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training import sched as psched
    from uniter_tpu_torch.training import step as pstep

    _, jmodel, params, _ = pair
    feed = [_batch(9, seed=1, pad_last=3), _batch(6, t=12, r=5, seed=2)]

    def jax_loss(p, batch, rng):
        per_group = jmodel.apply({"params": p}, batch, True, sample_size=3,
                                 deterministic=False, rngs={"dropout": rng})
        w = batch["ex_weight"].reshape(-1, 3)[:, :1]
        return (jnp.sum(per_group * w)
                / jnp.maximum(jnp.sum(w) * 2, 1.0)), {}

    sched = (1e-3, 2, 4)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = JaxState.create(jp, jopt.build_optimizer(
        jp, jsched.get_lr_schedule(*sched), grad_norm=1.0, fused=True))
    jstep = jax_step(jax_loss, loss_scale="sum", donate=False)
    model = pitm.UniterForImageTextRetrieval(pconfig.tiny_config(**NO_DROP),
                                             img_dim=IMG_DIM)
    model.load_state_dict(_bridge(params), strict=True)
    state = pstep.TrainState(step=0, model=model, opt=popt.build_optimizer(
        model, psched.get_lr_schedule(*sched), grad_norm=1.0, fused=True))
    step = pstep.make_train_step(lambda m, b, g: (rank_loss(m, b, g, 3), {}),
                                 loss_scale="sum")
    for batch in feed:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jax.random.PRNGKey(0))
        state, m = step(state, _tt(batch), 0)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    want = _bridge(jstate.params)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_hard_negative_mining_matches_jax(pair):
    _, _, params, _ = pair
    batch = _batch(8, seed=5)  # one group: row 0 the positive
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jitm.UniterForImageTextRetrievalHardNeg(
        jax_tiny(**NO_DROP), img_dim=IMG_DIM, hard_size=3)
    scores = np.asarray(jmodel.apply({"params": params}, jb, False))[:, 0]
    _, hard = jax.lax.top_k(jnp.asarray(scores[1:]), 3)
    want_idx = np.concatenate([[0], np.asarray(hard) + 1])
    want_loss = np.asarray(jmodel.apply({"params": params}, jb, True))
    model = pitm.UniterForImageTextRetrievalHardNeg(
        pconfig.tiny_config(**NO_DROP), img_dim=IMG_DIM, hard_size=3)
    model.load_state_dict(_bridge(params), strict=True)
    model.train()
    tb = _tt(batch)
    assert np.array_equal(model.mine(tb).numpy(), want_idx)
    assert model.training  # the scoring pass leaves the mode as it was
    loss = model(tb, True)
    assert loss.shape == (1, 3)
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="hard_size"):
        model({k: v[:3] for k, v in tb.items()}, True)


def test_seed_rank_head_from_a_checkpoint():
    """``rank_output`` takes row 1 of the checkpoint's ITM head; without
    an ITM head in the file, row 1 of the model's own."""
    torch.manual_seed(0)
    model = pitm.UniterForImageTextRetrieval(pconfig.tiny_config(),
                                             img_dim=IMG_DIM)
    itm_w = np.random.RandomState(0).randn(2, 64).astype(np.float32)
    pitm.seed_rank_head(model, {"itm_output.weight": itm_w,
                                "itm_output.bias": np.array([0.5, -0.25],
                                                            np.float32)})
    assert np.array_equal(model.rank_output.weight.detach().numpy(),
                          itm_w[1:2])
    assert model.rank_output.bias.item() == -0.25
    pitm.seed_rank_head(model, {})
    assert torch.equal(model.rank_output.weight, model.itm_output.weight[1:2])


# ------------------------------------------------------ data and the CLIs

MODEL_CFG = dict(vocab_size=300, hidden_size=48, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=96,
                 max_position_embeddings=64, type_vocab_size=2,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 hidden_act="gelu", initializer_range=0.02)
N_IMG, N_TXT = 12, 24


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """12 images and 24 captions (2 per image), written with the port's DB
    writers."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.txt_db import write_txt_db

    root = tmp_path_factory.mktemp("torch_itm")
    rng = np.random.RandomState(0)
    names = [f"flickr_{i:04d}.npz" for i in range(N_IMG)]
    imgs = {}
    for n in names:
        nbb = rng.randint(4, 10)
        imgs[n] = dict(features=rng.randn(nbb, 2048).astype(np.float16),
                       norm_bb=rng.rand(nbb, 6).astype(np.float16),
                       conf=np.linspace(1, 0.3, nbb).astype(np.float16),
                       soft_labels=rng.rand(nbb, 1601).astype(np.float16))
    write_img_db(str(root / "img"), imgs, conf_th=0.2, max_bb=10, min_bb=3)
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [104, 300]}
    recs, t2i = {}, {}
    for i in range(N_TXT):
        recs[f"cap_{i}"] = dict(
            input_ids=[int(x) for x in rng.randint(110, 300,
                                                   rng.randint(4, 12))],
            img_fname=names[i % N_IMG])
        t2i[f"cap_{i}"] = names[i % N_IMG]
    write_txt_db(str(root / "txt"), recs, meta, t2i)
    with open(root / "model.json", "w") as f:
        json.dump(dict(MODEL_CFG, ffn_impl="pallas"), f)
    return root


def _both_dbs(dbs):
    from uniter_tpu.data.img_db import DetectFeatDb as JImg
    from uniter_tpu.data.txt_db import TxtTokDb as JTxt
    from uniter_tpu_torch.data.img_db import DetectFeatDb
    from uniter_tpu_torch.data.txt_db import TxtTokDb

    kw = dict(conf_th=0.2, max_bb=10, min_bb=3)
    return ((JTxt(str(dbs / "txt"), max_txt_len=60),
             JImg(str(dbs / "img"), **kw)),
            (TxtTokDb(str(dbs / "txt"), max_txt_len=60),
             DetectFeatDb(str(dbs / "img"), **kw)))


def _equal_batches(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("name", ["ItmRankDataset",
                                  "ItmRankDatasetHardNegFromText",
                                  "ItmRankDatasetHardNegFromImage"])
def test_train_records_and_collates_match_jax(dbs, name):
    from uniter_tpu.data import itm as jdata
    from uniter_tpu_torch.data import itm as pdata

    (jt, ji), (pt, pi) = _both_dbs(dbs)
    neg = 2 if name == "ItmRankDataset" else 7
    jds = getattr(jdata, name)(jt, ji, neg_sample_size=neg)
    pds = getattr(pdata, name)(pt, pi, neg_sample_size=neg)
    assert pds.ids == jds.ids and pds.lens == jds.lens
    recs = []
    for i in range(len(pds)):
        want = jds.get_record(i, np.random.RandomState(i))
        got = pds.get_record(i, np.random.RandomState(i))
        assert len(got["rows"]) == len(want["rows"]) == (
            1 + 2 * neg if name == "ItmRankDataset" else 1 + neg)
        for g, w in zip(got["rows"], want["rows"]):
            for k in w:
                assert np.array_equal(g[k], w[k]), k
        recs.append((got, want))
    if name == "ItmRankDataset":
        got = pdata.ItmRankDataset.collate([r[0] for r in recs[:3]], 16, 12,
                                           4)
        want = jdata.ItmRankDataset.collate([r[1] for r in recs[:3]], 16, 12,
                                            4)
    else:
        got = pdata.hard_neg_collate(recs[0][0], 16, 12)
        want = jdata.hard_neg_collate(recs[0][1], 16, 12)
    _equal_batches(got, want)


@pytest.mark.parametrize("name", ["ItmValDataset", "ItmEvalDataset"])
def test_eval_datasets_match_jax(dbs, name):
    from uniter_tpu.data import itm as jdata
    from uniter_tpu_torch.data import itm as pdata

    (jt, ji), (pt, pi) = _both_dbs(dbs)
    jds = getattr(jdata, name)(jt, ji, mini_batch_size=5)
    pds = getattr(pdata, name)(pt, pi, mini_batch_size=5)
    assert pds.all_img_ids == jds.all_img_ids and pds.bs == 5
    assert pds.bucket_hint() == jds.bucket_hint()
    t_b, r_b = pds.bucket_hint()
    for i in (0, 7, N_TXT - 1):
        got, want = pds.get_batches(i, t_b, r_b), jds.get_batches(i, t_b, r_b)
        assert len(got) == len(want) == (1 if name == "ItmValDataset" else 3)
        for g, w in zip(got, want):
            _equal_batches(g, w)


@pytest.fixture(scope="module")
def scorers(dbs):
    """The same random retrieval model in both packages (2048-d regions)
    and both packages' eval datasets over the DBs."""
    from uniter_tpu.data import itm as jdata
    from uniter_tpu_torch.data import itm as pdata

    jcfg = JaxConfig.from_dict(MODEL_CFG, dtype="float32")
    jmodel = jitm.UniterForImageTextRetrieval(jcfg, img_dim=2048)
    dummy = dict(
        input_ids=np.ones((2, 8), np.int32),
        position_ids=np.tile(np.arange(8, dtype=np.int32), (2, 1)),
        img_feat=np.zeros((2, 6, 2048), np.float32),
        img_pos_feat=np.zeros((2, 6, 7), np.float32),
        attn_mask=np.ones((2, 14), np.int32))
    params = _jax_params(jmodel, dummy, seed=7)
    model = pitm.UniterForImageTextRetrieval(
        pconfig.UniterConfig.from_dict(MODEL_CFG, dtype="float32"),
        img_dim=2048)
    model.load_state_dict(_bridge(params), strict=True)
    (jt, ji), (pt, pi) = _both_dbs(dbs)
    return dict(jmodel=jmodel, params=params, model=model,
                jeval=jdata.ItmEvalDataset(jt, ji, mini_batch_size=5),
                peval=pdata.ItmEvalDataset(pt, pi, mini_batch_size=5),
                jval=jdata.ItmValDataset(jt, ji, mini_batch_size=5),
                pval=pdata.ItmValDataset(pt, pi, mini_batch_size=5))


def test_fast_score_matrix_matches_jax_and_batched(scorers):
    from uniter_tpu.utils.itm_fast import fast_score_matrix as jfast
    from uniter_tpu_torch.utils.itm_eval import (
        inference_score_matrix, itm_eval)
    from uniter_tpu_torch.utils.itm_fast import fast_score_matrix

    s = scorers
    t_b, r_b = s["peval"].bucket_hint()
    want, want_ids = jfast(s["jmodel"], s["params"], s["jeval"], t_b, r_b,
                           txt_tile=8, img_tile=8, dtype="float32")
    batched, b_ids = inference_score_matrix(
        s["model"].predict, s["peval"], t_b, r_b, "cpu")
    assert want.shape == batched.shape == (N_TXT, N_IMG)
    recalls = itm_eval(want, want_ids, s["jeval"].all_img_ids,
                       s["jeval"].txt2img, s["jeval"].img2txts)
    for cls_path in (True, False):
        got, ids = fast_score_matrix(s["model"], s["peval"], t_b, r_b,
                                     txt_tile=8, img_tile=8, dtype="float32",
                                     cls_path=cls_path)
        assert ids == want_ids == b_ids
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, batched, atol=1e-5, rtol=0)
        assert itm_eval(got, ids, s["peval"].all_img_ids, s["peval"].txt2img,
                        s["peval"].img2txts) == recalls
    # one process scores every text; the stride split over several
    # (rows r::world) is held at world 2 in test_torch_parallel.py
    from uniter_tpu_torch.utils.itm_fast import gather_rows, my_rows

    np.testing.assert_array_equal(my_rows(N_TXT), np.arange(N_TXT))
    assert gather_rows(want, N_TXT) is want


def test_fast_windowed_scores_match_jax_and_batched(scorers):
    from uniter_tpu.utils.itm_fast import fast_windowed_scores as jwin
    from uniter_tpu_torch.train_itm import validate_retrieval
    from uniter_tpu_torch.utils.itm_fast import fast_windowed_scores

    s = scorers
    t_b, r_b = s["pval"].bucket_hint()
    want, _ = jwin(s["jmodel"], s["params"], s["jval"], t_b, r_b,
                   txt_chunk=4, dtype="float32")
    got, ids = fast_windowed_scores(s["model"], s["pval"], t_b, r_b,
                                    txt_chunk=4, dtype="float32")
    assert got.shape == (N_TXT, 5) and ids == s["pval"].ids
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    logs = {impl: validate_retrieval(s["model"], s["pval"], impl=impl)
            for impl in ("fast", "batched")}
    assert logs["fast"] == logs["batched"]
    assert s["model"].training


def _run(args):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def _conf(dbs, out, **kw):
    conf = dict(train_txt_db=str(dbs / "txt"), train_img_db=str(dbs / "img"),
                val_txt_db=str(dbs / "txt"), val_img_db=str(dbs / "img"),
                model_config=str(dbs / "model.json"), output_dir=str(out),
                max_bb=10, min_bb=3, n_workers=0, warmup_steps=2,
                valid_steps=2, log_steps=1, inf_minibatch_size=6,
                device="cpu", **kw)
    path = str(out) + ".json"
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


def test_train_itm_cli_trains_resumes_and_scores(dbs):
    out = dbs / "run"
    path = _conf(dbs, out, train_batch_size=256, num_train_steps=3)
    proc = _run(["-m", "uniter_tpu_torch.train_itm", "--config", path])
    assert proc.returncode == 0, proc.stderr[-3000:]
    # the model config asks for the FFN kernel; the CPU resolves it away
    assert "ffn xla" in proc.stderr
    assert {"model_step_2.pt", "model_step_3.pt"} <= set(
        os.listdir(out / "ckpt"))
    scalars = [json.loads(line)
               for line in open(out / "log" / "scalars.jsonl")]
    rm = [s["valid/r_mean"] for s in scalars if "valid/r_mean" in s]
    assert rm and all(0.0 <= v <= 1.0 for v in rm)
    proc = _run(["-m", "uniter_tpu_torch.train_itm", "--config", path,
                 "--num_train_steps", "4"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed from step 3" in proc.stderr
    assert "model_step_4.pt" in os.listdir(out / "ckpt")

    args = ["--txt_db", str(dbs / "txt"), "--img_db", str(dbs / "img"),
            "--max_bb", "10", "--min_bb", "3", "--device", "cpu",
            "--txt_tile", "8", "--img_tile", "8"]
    outs = {}
    for impl in ("fast", "batched"):
        outs[impl] = dbs / f"pred_{impl}"
        proc = _run(["-m", "uniter_tpu_torch.inf_itm", *args, "--train_dir",
                     str(out), "--output_dir", str(outs[impl]),
                     "--eval_impl", impl])
        assert proc.returncode == 0, proc.stderr[-3000:]
    mats = [np.load(outs[i] / "score_matrix.npz") for i in outs]
    assert mats[0]["score_matrix"].shape == (N_TXT, N_IMG)
    assert mats[0]["score_matrix"].dtype == np.float16
    np.testing.assert_allclose(mats[0]["score_matrix"].astype(np.float32),
                               mats[1]["score_matrix"].astype(np.float32),
                               atol=1e-3, rtol=1e-3)
    res = [json.load(open(outs[i] / "results.json")) for i in outs]
    assert res[0] == res[1] and 0.0 <= res[0]["r_mean"] <= 1.0


def test_inf_itm_zero_shot_matches_jax(dbs):
    """A reference-format ``.pt`` written with the JAX ``export_state_dict``:
    the root ``inf_itm.py`` and ``python -m uniter_tpu_torch.inf_itm``
    (both zero-shot: ``--model_config`` and ``--ckpt``) write the same
    results.json and score matrices within fp16 storage (1e-3)."""
    import inf_itm
    from uniter_tpu.models.checkpoint import export_state_dict

    jcfg = JaxConfig.from_dict(MODEL_CFG, dtype="float32")
    jmodel = jitm.UniterForImageTextRetrieval(jcfg, img_dim=2048)
    dummy = dict(
        input_ids=np.ones((2, 8), np.int32),
        position_ids=np.tile(np.arange(8, dtype=np.int32), (2, 1)),
        img_feat=np.zeros((2, 6, 2048), np.float32),
        img_pos_feat=np.zeros((2, 6, 7), np.float32),
        attn_mask=np.ones((2, 14), np.int32))
    params = _jax_params(jmodel, dummy, seed=11)
    ckpt = str(dbs / "pretrained.pt")
    torch.save({k: torch.tensor(np.asarray(v))
                for k, v in export_state_dict(params).items()}, ckpt)
    args = ["--txt_db", str(dbs / "txt"), "--img_db", str(dbs / "img"),
            "--max_bb", "10", "--min_bb", "3", "--model_config",
            str(dbs / "model.json"), "--ckpt", ckpt, "--txt_tile", "8",
            "--img_tile", "8"]
    jax_out, port_out = str(dbs / "zs_jax"), str(dbs / "zs_port")
    inf_itm.main(inf_itm.get_parser().parse_args(
        args + ["--output_dir", jax_out]))
    proc = _run(["-m", "uniter_tpu_torch.inf_itm", *args, "--output_dir",
                 port_out, "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(os.path.join(jax_out, "score_matrix.npz"))
    got = np.load(os.path.join(port_out, "score_matrix.npz"))
    assert list(got["txt_ids"]) == list(want["txt_ids"])
    assert list(got["img_ids"]) == list(want["img_ids"])
    np.testing.assert_allclose(got["score_matrix"].astype(np.float32),
                               want["score_matrix"].astype(np.float32),
                               atol=1e-3, rtol=1e-3)
    assert (json.load(open(os.path.join(port_out, "results.json")))
            == json.load(open(os.path.join(jax_out, "results.json"))))


def test_train_itm_hard_negatives_cli_trains_and_resumes(dbs):
    out = dbs / "hn_run"
    path = _conf(dbs, out, train_batch_size=2, num_train_steps=2,
                 negative_size=7, hard_neg_size=3, txt_bucket=16,
                 img_bucket=12)
    proc = _run(["-m", "uniter_tpu_torch.train_itm_hard_negatives",
                 "--config", path])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ffn xla" in proc.stderr
    scalars = [json.loads(line)
               for line in open(out / "log" / "scalars.jsonl")]
    assert any("perf/hn_per_s" in s for s in scalars)
    assert any("valid/r_mean" in s for s in scalars)
    proc = _run(["-m", "uniter_tpu_torch.train_itm_hard_negatives",
                 "--config", path, "--num_train_steps", "3"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ("resumed from step 2: fast-forwarded mining streams by 4 "
            "candidate batches") in proc.stderr
    assert "model_step_3.pt" in os.listdir(out / "ckpt")
    proc = _run(["-m", "uniter_tpu_torch.train_itm_hard_negatives",
                 "--config", path, "--negative_size", "6"])
    assert proc.returncode != 0 and "multiple of 8" in proc.stderr


# ------------------------------------------------------ over two processes

def test_train_itm_and_inf_itm_over_two_processes(dbs):
    out = dbs / "run_two"
    run_cli("train_itm", ["--config", _conf(dbs, out, train_batch_size=256,
                                            num_train_steps=3)])
    assert "model_step_3.pt" in os.listdir(out / "ckpt")
    for impl in ("fast", "batched"):
        got = []
        for world in (1, 2):
            ans = dbs / f"two_{impl}{world}"
            run_cli("inf_itm", ["--txt_db", str(dbs / "txt"), "--img_db",
                                str(dbs / "img"), "--train_dir", str(out),
                                "--output_dir", str(ans), "--device", "cpu",
                                "--batch_size", "5", "--eval_impl", impl],
                    world)
            got.append((np.load(ans / "score_matrix.npz"),
                        json.load(open(ans / "results.json"))))
        (m1, r1), (m2, r2) = got
        assert (m1["txt_ids"] == m2["txt_ids"]).all() and r1 == r2
        np.testing.assert_allclose(m2["score_matrix"].astype(np.float32),
                                   m1["score_matrix"].astype(np.float32),
                                   atol=1e-3)


def test_train_itm_hard_negatives_over_two_processes(dbs):
    out = dbs / "hn_two"
    path = _conf(dbs, out, train_batch_size=2, num_train_steps=2,
                 negative_size=7, hard_neg_size=3, txt_bucket=16,
                 img_bucket=12)
    run_cli("train_itm_hard_negatives", ["--config", path])
    outs = run_cli("train_itm_hard_negatives", ["--config", path,
                                                "--num_train_steps", "3"])
    assert any("fast-forwarded mining streams by 4" in o for o in outs)
    assert "model_step_3.pt" in os.listdir(out / "ckpt")


def test_train_itm_hard_negatives_under_fsdp_is_the_one_process_run(dbs):
    """``train_itm_hard_negatives`` at dropout 0.1, 2 steps of 2 candidate
    batches, validating and saving at step 2: at world 2 with ``--fsdp``
    (each rank mines and trains one candidate batch a step and draws the
    dropout stream of the one process's same candidate batch; the
    parameters sharded at rest, the validation gathered once) the saved
    weights equal world 1's (1e-5)."""
    weights = {}
    for name, world, extra in (("hn_w1", 1, []),
                               ("hn_w2_fsdp", 2,
                                ["--fsdp", "--fsdp_min_size", "64"])):
        out = dbs / name
        path = _conf(dbs, out, train_batch_size=2, num_train_steps=2,
                     negative_size=7, hard_neg_size=3, txt_bucket=16,
                     img_bucket=12, dropout=0.1)
        run_cli("train_itm_hard_negatives", ["--config", path, *extra],
                world)
        weights[name] = torch.load(out / "ckpt" / "model_step_2.pt",
                                   weights_only=True)
    want, got = weights["hn_w1"], weights["hn_w2_fsdp"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
