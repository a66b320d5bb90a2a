"""The port's NLVR2 models, data, driver surgery and CLIs against the JAX
package, on the CPU (tiny config, fp32, dropout off unless stated).

* The weight bridge for the three models equals JAX ``export_state_dict``
  key for key and bit for bit, and loads with ``strict=True``.
* Logits and per-example losses of paired, triplet and paired-attn to 1e-5;
  parameter gradients against ``jax.grad`` to 1e-5 of each tensor's
  largest entry (+1e-6): fp32 rounding of another summation order through
  two layers.
* ``CrossAttention`` alone (padded keys, both directions) to 1e-5.
* Both NLVR2 collates equal the JAX package's on the same DBs, array for
  array.
* The token-type widening of ``load_trunk_checkpoint`` equals the JAX
  driver's: rows 0-1 from a 2-row checkpoint, row 1 copied into row 2.
* Four train steps of paired-attn match the JAX train step: loss and
  gradient norm to rtol 1e-5, parameters to atol 1e-5.
* ``python -m uniter_tpu_torch.train_nlvr2 --device cpu`` trains,
  validates, saves and resumes; the port's ``inf_nlvr2`` writes one
  ``results.csv`` row per example; on one JAX-written run directory the
  port's ``inf_nlvr2`` writes the same ``results.csv`` as the root
  ``inf_nlvr2.py``.
* Over two gloo processes ``train_nlvr2`` validates on every example (13)
  and ``inf_nlvr2`` at world 2 writes world 1's ``results.csv``.
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
from uniter_tpu.models.heads import CrossAttention as JaxCrossAttention
from uniter_tpu.models.nlvr2 import MODEL_REGISTRY as JAX_MODELS
from uniter_tpu_torch import config as pconfig
from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
from uniter_tpu_torch.models.heads import CrossAttention
from uniter_tpu_torch.models.nlvr2 import MODEL_REGISTRY
from test_torch_parallel import run_cli

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
torch.set_num_threads(2)

IMG_DIM = 32
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               type_vocab_size=3)
KINDS = ["paired", "triplet", "paired-attn"]


def _batch(kind, n_ex=3, t=8, r=6, seed=0):
    """n_ex examples: 2 rows each (left, right; image types 1/2) for the
    paired models, one row with both images for the triplet model."""
    rng = np.random.RandomState(seed)
    rows = n_ex if kind == "triplet" else 2 * n_ex
    attn = np.ones((rows, t + r), np.int32)
    attn[0, t - 3:t] = 0
    attn[1, t + r - 2:] = 0
    img_type = np.ones((rows, r), np.int32)
    if kind == "triplet":
        img_type[:, r // 2:] = 2
    else:
        img_type[1::2] = 2
    return dict(
        input_ids=rng.randint(1, 500, (rows, t)).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (rows, 1)),
        img_feat=rng.randn(rows, r, IMG_DIM).astype(np.float32),
        img_pos_feat=rng.rand(rows, r, 7).astype(np.float32),
        attn_mask=attn, img_type_ids=img_type,
        targets=rng.randint(0, 2, n_ex).astype(np.int32),
        ex_weight=np.array([1.0] * (n_ex - 1) + [0.0], np.float32))


def _jax_params(model, batch, seed=0):
    params = model.init({"params": jax.random.PRNGKey(seed)},
                        {k: jnp.asarray(v) for k, v in batch.items()},
                        False)["params"]
    rng = np.random.RandomState(seed + 1)
    return jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, x.shape)).astype(
            np.float32), jax.tree.map(np.asarray, dict(params)))


def _bridge(tree):
    return {k: torch.tensor(np.asarray(v, np.float32))
            for k, v in state_dict_from_jax_params(tree).items()}


def _tt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    kind = request.param
    batch = _batch(kind)
    jmodel = JAX_MODELS[kind](jax_tiny(**NO_DROP), img_dim=IMG_DIM)
    params = _jax_params(jmodel, batch)
    model = MODEL_REGISTRY[kind](pconfig.tiny_config(**NO_DROP),
                                 img_dim=IMG_DIM)
    model.load_state_dict(_bridge(params), strict=True)
    return SimpleNamespace(kind=kind, batch=batch, jmodel=jmodel,
                           params=params, model=model)


def test_bridge_matches_export_state_dict(pair):
    ours = state_dict_from_jax_params(pair.params)
    theirs = export_state_dict(pair.params)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == np.asarray(v).dtype
        assert np.array_equal(ours[k], np.asarray(v)), k
    assert sorted(ours) == sorted(pair.model.state_dict())


def test_logits_loss_and_grads_match_jax(pair):
    batch = pair.batch
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_logits = pair.jmodel.apply({"params": pair.params}, jb, False)
    want_loss = pair.jmodel.apply({"params": pair.params}, jb, True)

    def mean_loss(p):
        return jnp.mean(pair.jmodel.apply({"params": p}, jb, True))

    want_grads = _bridge(jax.grad(mean_loss)(
        jax.tree.map(jnp.asarray, pair.params)))
    model = pair.model
    model.zero_grad()
    tb = _tt(batch)
    logits = model(tb, False)
    loss = model(tb)
    loss.mean().backward()
    n = len(batch["targets"])
    assert logits.shape == (n, 2) and loss.shape == (n,)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=1e-5, rtol=0)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               atol=1e-5, rtol=0)
    for k, p in model.named_parameters():
        want = want_grads[k].numpy()
        got = (p.grad.numpy() if p.grad is not None
               else np.zeros_like(want))  # mask_embedding: unused
        np.testing.assert_allclose(
            got, want, atol=1e-5 * np.abs(want).max() + 1e-6, rtol=0,
            err_msg=k)


def test_cross_attention_matches_jax():
    cfg = jax_tiny(**NO_DROP)
    rng = np.random.RandomState(4)
    q, kv = (rng.randn(3, 9, cfg.hidden_size).astype(np.float32)
             for _ in range(2))
    pad = np.zeros((3, 9), bool)
    pad[0, 5:] = True
    pad[2, 1:] = True
    jmod = JaxCrossAttention(cfg)
    params = jmod.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(q),
                       jnp.asarray(kv), jnp.asarray(kv))["params"]
    params = jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, x.shape)).astype(
            np.float32), jax.tree.map(np.asarray, dict(params)))
    mod = CrossAttention(pconfig.tiny_config(**NO_DROP))
    mod.load_state_dict({
        "in_proj_weight": torch.tensor(params["in_proj_weight"]),
        "in_proj_bias": torch.tensor(params["in_proj_bias"]),
        "out_proj.weight": torch.tensor(params["out_proj"]["kernel"].T),
        "out_proj.bias": torch.tensor(params["out_proj"]["bias"])})
    for mask in (None, pad):
        want = jmod.apply({"params": params}, jnp.asarray(q), jnp.asarray(kv),
                          jnp.asarray(kv), key_padding_mask=None if mask is None
                          else jnp.asarray(mask))
        got = mod(torch.tensor(q), torch.tensor(kv), torch.tensor(kv),
                  key_padding_mask=None if mask is None
                  else torch.tensor(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)


def test_train_steps_match_jax():
    """4 steps of paired-attn, dropout 0, ``loss_scale="sum"``, the ex_weight
    mean of the driver (train_nlvr2.py:129-139), batches of two shapes."""
    from uniter_tpu.training import optim as jopt
    from uniter_tpu.training import sched as jsched
    from uniter_tpu.training.step import TrainState as JaxState
    from uniter_tpu.training.step import make_train_step as jax_step
    from uniter_tpu_torch.train_nlvr2 import nlvr2_loss
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training import sched as psched
    from uniter_tpu_torch.training import step as pstep

    feed = [_batch("paired-attn", 3, 8, 6, s) if s % 2 == 0
            else _batch("paired-attn", 2, 12, 5, s) for s in range(4)]
    jmodel = JAX_MODELS["paired-attn"](jax_tiny(**NO_DROP), img_dim=IMG_DIM)
    params = _jax_params(jmodel, feed[0], seed=3)

    def jax_loss(p, batch, rng):
        per_ex = jmodel.apply({"params": p}, batch, True, deterministic=False,
                              rngs={"dropout": rng})
        w = batch["ex_weight"][:per_ex.shape[0]]
        return jnp.sum(per_ex * w) / jnp.maximum(jnp.sum(w), 1.0), {}

    sched = (1e-3, 2, 4)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = JaxState.create(jp, jopt.build_optimizer(
        jp, jsched.get_lr_schedule(*sched), grad_norm=1.0, fused=True))
    jstep = jax_step(jax_loss, loss_scale="sum", donate=False)
    model = MODEL_REGISTRY["paired-attn"](pconfig.tiny_config(**NO_DROP),
                                          img_dim=IMG_DIM)
    model.load_state_dict(_bridge(params), strict=True)
    state = pstep.TrainState(step=0, model=model, opt=popt.build_optimizer(
        model, psched.get_lr_schedule(*sched), grad_norm=1.0, fused=True))
    step = pstep.make_train_step(
        lambda m, b, g: (nlvr2_loss(m, b, g), {}), loss_scale="sum")
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


def test_type_row_widening_matches_jax_driver(tmp_path):
    """A 2-row reference checkpoint into a 3-row NLVR2 trunk, both drivers;
    a trunk key of another shape raises ``ValueError``, a word table of
    another size too."""
    from uniter_tpu.training.driver import load_trunk_checkpoint as jax_load
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch.training.driver import load_trunk_checkpoint

    torch.manual_seed(0)
    src = UniterForVisualQuestionAnswering(pconfig.tiny_config(),
                                           img_dim=IMG_DIM, num_answer=5)
    sd = src.state_dict()
    assert sd["uniter.embeddings.token_type_embeddings.weight"].shape[0] == 2
    path = str(tmp_path / "ref.pt")
    torch.save(sd, path)
    opts = SimpleNamespace(checkpoint=path)

    batch = _batch("paired-attn")
    jcfg = jax_tiny(**NO_DROP)
    jmodel = JAX_MODELS["paired-attn"](jcfg, img_dim=IMG_DIM)
    jparams = jax_load(_jax_params(jmodel, batch), opts, jcfg, n_type_rows=3,
                       type_copy_row=1)
    model = MODEL_REGISTRY["paired-attn"](pconfig.tiny_config(**NO_DROP),
                                          img_dim=IMG_DIM)
    load_trunk_checkpoint(model, opts, n_type_rows=3, type_copy_row=1)
    want = _bridge(jax.tree.map(np.asarray, jparams))
    for k, v in model.uniter.state_dict().items():
        assert torch.equal(v, want["uniter." + k]), k
    tt = model.uniter.embeddings.token_type_embeddings.weight
    src_tt = sd["uniter.embeddings.token_type_embeddings.weight"]
    assert torch.equal(tt[:2], src_tt) and torch.equal(tt[2], src_tt[1])

    # without the surgery the 2-row table does not fit the 3-row trunk: the
    # merge raises and names the key and both shapes, as the JAX driver does
    with pytest.raises(ValueError, match=r"token_type_embeddings.*\(2, 64\)"
                                         r".*\(3, 64\)"):
        load_trunk_checkpoint(model, opts)
    with pytest.raises(ValueError, match="token_type_embeddings"):
        jax_load(_jax_params(jmodel, batch), opts, jcfg)
    # a word table of another size raises as any trunk key does (the
    # word widening is asked for with n_special_words, VCR's surgery)
    sd["uniter.embeddings.word_embeddings.weight"] = torch.zeros(7, 64)
    torch.save(sd, path)
    with pytest.raises(ValueError, match="word"):
        load_trunk_checkpoint(model, opts, n_type_rows=3)


# ------------------------------------------------------ data and the CLIs

MODEL_CFG = dict(vocab_size=300, hidden_size=48, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=96,
                 max_position_embeddings=64, type_vocab_size=2,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 hidden_act="gelu", initializer_range=0.02)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """8 images and 14 examples of 2 images each, written with the port's
    DB writers: ``txt`` labeled (training), ``txt_val`` with one example
    unlabeled."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.txt_db import write_txt_db

    root = tmp_path_factory.mktemp("torch_nlvr2")
    rng = np.random.RandomState(0)
    names = [f"nlvr2_{i:04d}.npz" for i in range(8)]
    imgs = {}
    for n in names:
        nbb = rng.randint(5, 10)
        imgs[n] = dict(features=rng.randn(nbb, 2048).astype(np.float16),
                       norm_bb=rng.rand(nbb, 6).astype(np.float16),
                       conf=np.linspace(1, 0.3, nbb).astype(np.float16),
                       soft_labels=rng.rand(nbb, 1601).astype(np.float16))
    write_img_db(str(root / "img"), imgs, conf_th=0.2, max_bb=10, min_bb=3)
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [104, 300]}
    recs, t2i = {}, {}
    for i in range(14):
        pair = [names[(2 * i) % 8], names[(2 * i + 3) % 8]]
        recs[f"ex_{i}"] = dict(
            input_ids=[int(x) for x in rng.randint(110, 300,
                                                   rng.randint(4, 10))],
            img_fname=pair, target=i % 2)
        t2i[f"ex_{i}"] = pair
    write_txt_db(str(root / "txt"), recs, meta, t2i)
    # the same examples with ex_13 unlabeled, as a leaderboard split is
    recs["ex_13"] = dict(recs["ex_13"], target=None)
    write_txt_db(str(root / "txt_val"), recs, meta, t2i)
    with open(root / "model.json", "w") as f:
        json.dump(MODEL_CFG, f)
    return root


@pytest.mark.parametrize("kind", ["paired", "triplet"])
def test_collates_match_jax(dbs, kind):
    from uniter_tpu.data.buckets import spec_from_dataset as jspec
    from uniter_tpu.data.img_db import DetectFeatDb as JImg
    from uniter_tpu.data.loader import BucketLoader as JLoader
    from uniter_tpu.data.nlvr2 import (Nlvr2PairedDataset as JPaired,
                                       Nlvr2TripletDataset as JTriplet)
    from uniter_tpu.data.txt_db import TxtTokDb as JTxt
    from uniter_tpu_torch.data.buckets import spec_from_dataset
    from uniter_tpu_torch.data.img_db import DetectFeatDb
    from uniter_tpu_torch.data.loader import BucketLoader
    from uniter_tpu_torch.data.nlvr2 import (Nlvr2PairedDataset,
                                             Nlvr2TripletDataset)
    from uniter_tpu_torch.data.txt_db import TxtTokDb

    def batches(cls, txt, img, spec, loader):
        ds = cls(txt(str(dbs / "txt_val"), max_txt_len=-1),
                 img(str(dbs / "img"), conf_th=0.2, max_bb=10, min_bb=3))
        return list(loader(ds, spec(ds, 96), shuffle=False, drop_last=False))

    jcls, pcls = ((JPaired, Nlvr2PairedDataset) if kind == "paired"
                  else (JTriplet, Nlvr2TripletDataset))
    want = batches(jcls, JTxt, JImg, jspec, JLoader)
    got = batches(pcls, TxtTokDb, DetectFeatDb, spec_from_dataset,
                  BucketLoader)
    assert len(got) == len(want) > 1
    assert sum(len(b["qids"]) for b in got) == 14
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype and np.array_equal(g[k], v), k
            else:
                assert g[k] == v, k


def _run(args):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def _read_csv(path):
    with open(path) as f:
        return [tuple(line.strip().split(",")) for line in f if line.strip()]


def test_train_nlvr2_cli_trains_resumes_and_predicts(dbs):
    out = dbs / "run"
    conf = dict(train_txt_db=str(dbs / "txt"), train_img_db=str(dbs / "img"),
                val_txt_db=str(dbs / "txt_val"), val_img_db=str(dbs / "img"),
                model_config=str(dbs / "model.json"), output_dir=str(out),
                train_batch_size=128, val_batch_size=256, max_bb=10,
                min_bb=3, n_workers=0, warmup_steps=2, valid_steps=2,
                log_steps=1, num_train_steps=3, device="cpu")
    path = str(dbs / "train.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    proc = _run(["-m", "uniter_tpu_torch.train_nlvr2", "--config", path])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "block_fusion none" in proc.stderr  # the CPU runs the plain tails
    assert {"model_step_2.pt", "model_step_3.pt"} <= set(
        os.listdir(out / "ckpt"))
    scalars = [json.loads(line) for line in open(out / "log" /
                                                 "scalars.jsonl")]
    accs = [s["valid/acc"] for s in scalars if "valid/acc" in s]
    assert accs and all(0.0 <= a <= 1.0 for a in accs)
    # the unlabeled example is left out of the accuracy
    assert all(s["valid/n_ex"] == 13 for s in scalars if "valid/n_ex" in s)
    with open(out / "log" / "model.json") as f:
        assert json.load(f)["type_vocab_size"] == 3

    proc = _run(["-m", "uniter_tpu_torch.train_nlvr2", "--config", path,
                 "--num_train_steps", "5"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed from step 3" in proc.stderr
    assert "model_step_5.pt" in os.listdir(out / "ckpt")

    proc = _run(["-m", "uniter_tpu_torch.inf_nlvr2", "--txt_db",
                 str(dbs / "txt_val"), "--img_db", str(dbs / "img"),
                 "--train_dir", str(out), "--output_dir", str(dbs / "pred"),
                 "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = _read_csv(dbs / "pred" / "results.csv")
    assert sorted(q for q, _ in rows) == sorted(f"ex_{i}" for i in range(14))
    assert {lab for _, lab in rows} <= {"True", "False"}


@pytest.mark.parametrize("kind", ["paired-attn", "triplet"])
def test_port_inf_nlvr2_matches_jax(dbs, kind):
    """One training directory written as a JAX run stores it (hps.json with
    ``attention_impl="pallas"``, model.json, a msgpack snapshot): the root
    ``inf_nlvr2.py`` and ``python -m uniter_tpu_torch.inf_nlvr2 --device
    cpu`` write the same results.csv."""
    import inf_nlvr2
    from uniter_tpu.config import UniterConfig
    from uniter_tpu.utils.save import save_params_msgpack

    train_dir = dbs / f"jax_{kind}"
    os.makedirs(train_dir / "log")
    os.makedirs(train_dir / "ckpt")
    with open(train_dir / "log" / "model.json", "w") as f:
        json.dump(MODEL_CFG, f)
    with open(train_dir / "log" / "hps.json", "w") as f:
        json.dump(dict(model=kind, conf_th=0.2, max_bb=10, min_bb=3,
                       num_bb=36, use_img_type=1, compressed_db=False,
                       attention_impl="pallas"), f)
    cfg = UniterConfig.from_dict(MODEL_CFG, dtype="float32",
                                 type_vocab_size=3)
    model = JAX_MODELS[kind](cfg, img_dim=2048)
    rows = 4 if kind == "triplet" else 8
    dummy = dict(
        input_ids=np.ones((rows, 8), np.int32),
        position_ids=np.tile(np.arange(8, dtype=np.int32), (rows, 1)),
        img_feat=np.zeros((rows, 6, 2048), np.float32),
        img_pos_feat=np.zeros((rows, 6, 7), np.float32),
        attn_mask=np.ones((rows, 14), np.int32),
        img_type_ids=np.ones((rows, 6), np.int32))
    params = model.init({"params": jax.random.PRNGKey(1)}, dummy,
                        False)["params"]
    rng = np.random.RandomState(2)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.1, x.shape)).astype(
            np.float32), jax.tree.map(np.asarray, dict(params)))
    # center the output bias on the median logit margin over the DB, so
    # both labels occur and no example sits near a tie
    from uniter_tpu.data.buckets import spec_from_dataset
    from uniter_tpu.data.img_db import DetectFeatDb
    from uniter_tpu.data.loader import BucketLoader
    from uniter_tpu.data.nlvr2 import Nlvr2PairedDataset, Nlvr2TripletDataset
    from uniter_tpu.data.txt_db import TxtTokDb

    cls = Nlvr2TripletDataset if kind == "triplet" else Nlvr2PairedDataset
    ds = cls(TxtTokDb(str(dbs / "txt_val"), max_txt_len=-1),
             DetectFeatDb(str(dbs / "img"), conf_th=0.2, max_bb=10, min_bb=3))
    margins = []
    for b in BucketLoader(ds, spec_from_dataset(ds, 256), shuffle=False,
                          drop_last=False):
        jb = {k: jnp.asarray(v) for k, v in b.items()
              if isinstance(v, np.ndarray)}
        out = np.asarray(model.apply({"params": params}, jb, False))
        margins += list((out[:, 1] - out[:, 0])[:len(b["qids"])])
    mid = float(np.median(margins))
    params["nlvr2_output"]["bias"] = np.array([0.0, -mid], np.float32)
    assert np.min(np.abs(np.asarray(margins) - mid)) > 1e-3
    save_params_msgpack(str(train_dir / "ckpt" / "model_step_3.msgpack"),
                        params)
    args = ["--txt_db", str(dbs / "txt_val"), "--img_db", str(dbs / "img"),
            "--train_dir", str(train_dir), "--batch_size", "256"]
    jax_out = str(dbs / f"jax_pred_{kind}")
    inf_nlvr2.main(inf_nlvr2.get_parser().parse_args(
        args + ["--output_dir", jax_out]))
    port_out = str(dbs / f"port_pred_{kind}")
    proc = _run(["-m", "uniter_tpu_torch.inf_nlvr2", *args, "--output_dir",
                 port_out, "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = _read_csv(os.path.join(jax_out, "results.csv"))
    got = _read_csv(os.path.join(port_out, "results.csv"))
    assert len(want) == 14 and {lab for _, lab in want} == {"True", "False"}
    assert got == want


# ------------------------------------------------------ over two processes

def test_train_nlvr2_and_inf_nlvr2_over_two_processes(dbs):
    out = dbs / "run_two"
    conf = dict(train_txt_db=str(dbs / "txt"), train_img_db=str(dbs / "img"),
                val_txt_db=str(dbs / "txt_val"), val_img_db=str(dbs / "img"),
                model_config=str(dbs / "model.json"), output_dir=str(out),
                train_batch_size=128, val_batch_size=256, max_bb=10,
                min_bb=3, n_workers=0, warmup_steps=2, valid_steps=2,
                log_steps=1, num_train_steps=3, device="cpu")
    path = str(dbs / "train_two.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    run_cli("train_nlvr2", ["--config", path])
    scalars = [json.loads(line) for line in open(out / "log" /
                                                 "scalars.jsonl")]
    n_ex = [s["valid/n_ex"] for s in scalars if "valid/n_ex" in s]
    assert n_ex == [13]  # step 2; the unlabeled example left out
    csv = []
    for world in (1, 2):
        run_cli("inf_nlvr2", ["--txt_db", str(dbs / "txt_val"), "--img_db",
                              str(dbs / "img"), "--train_dir", str(out),
                              "--output_dir", str(dbs / f"two_ans{world}"),
                              "--device", "cpu"], world)
        csv.append(open(dbs / f"two_ans{world}" / "results.csv").read())
    assert csv[0] and csv[1] == csv[0]
