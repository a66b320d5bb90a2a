"""The port's pretraining slice against the JAX package, on the CPU (tiny
config, fp32, dropout off unless stated; OT through the plain ``ipot``,
the JAX side through its ``lax.scan`` reference).

* The weight bridge for ``UniterForPretraining`` equals JAX
  ``export_state_dict`` key for key, in order and bit for bit, and loads
  with ``strict=True``: the tied MLM decoder and MRFR projection register
  no key.
* Per task (mlm, mrfr, itm, mrc, mrc-kl): logits to 1e-4, the scalar loss
  and its metrics (``itm_xe``, ``itm_ot`` or the task's name) to 1e-4
  relative, parameter gradients against ``jax.grad`` to 1e-4 of each
  tensor's largest entry (+1e-6): fp32 rounding of another summation order
  through two layers and 50 OT steps.
* The weight-decay mask equals the JAX package's key by key.
* ``MlmDataset``, ``MrfrDataset``, ``MrcDataset`` and ``ItmDataset``
  records and collates equal the JAX package's bit for bit from the same
  ``RandomState``.
* Two train steps per task match the JAX step (loss, gradient norm and
  metrics to rtol 1e-5, parameters to atol 1e-5), accumulation 1 and 2.
* ``MetaLoader`` and ``MixedTaskLoop`` draw the JAX ``MetaLoader``'s task
  order from the same seed.
* The CLI: 4 steps straight equal a run preempted after 2 steps and rerun
  to 4, bit for bit; the
  module entry point trains, validates all four tasks and saves; the head
  checkpoint round trip, with a head tensor of another shape skipped and
  logged where a trunk tensor raises.
* Over two gloo processes with ``--fsdp``, ``pretrain`` trains,
  validates, and resumes without ``--fsdp``.
"""

import json
import logging
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
from uniter_tpu.models.pretrain import UniterForPretraining as JaxPretrain
from uniter_tpu_torch import config as pconfig
from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
from uniter_tpu_torch.models.pretrain import UniterForPretraining
from test_torch_parallel import run_cli

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
torch.set_num_threads(2)

IMG_DIM = 32
LABEL_DIM = 11
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
TASKS = ["mlm", "mrfr", "itm", "mrc", "mrc-kl"]
OT_LAMBDA = 0.1


def _batch(b=4, t=8, r=6, seed=0):
    """One batch with every task's fields: ragged text and regions, 3 MLM
    and 2 MRM slots (one of each invalid), ITM targets 1/0 and a collate
    padding row (target -1, all padding)."""
    rng = np.random.RandomState(seed)
    attn = np.ones((b, t + r), np.int32)
    attn[0, t - 3:t] = 0
    attn[1, t + r - 2:] = 0
    attn[b - 1] = 0
    soft = rng.rand(b, 2, LABEL_DIM).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    mlm_tgt = rng.randint(1, 500, (b, 3)).astype(np.int32)
    mlm_tgt[:, 2] = -1
    mlm_tgt[b - 1] = -1
    valid = np.ones((b, 2), np.float32)
    valid[0, 1] = 0
    valid[b - 1] = 0
    img_masks = np.zeros((b, r), np.int32)
    img_masks[:, 0] = 1
    targets = np.array(([1, 0] * b)[:b], np.int32)
    targets[b - 1] = -1
    weight = np.ones(b, np.float32)
    weight[b - 1] = 0
    return dict(
        input_ids=rng.randint(1, 500, (b, t)).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        img_feat=rng.randn(b, r, IMG_DIM).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=attn, img_masks=img_masks, ex_weight=weight,
        mlm_pos=rng.randint(0, t, (b, 3)).astype(np.int32), mlm_tgt=mlm_tgt,
        mrm_pos=np.tile(np.array([0, 2], np.int32), (b, 1)), mrm_valid=valid,
        feat_targets=rng.randn(b, 2, IMG_DIM).astype(np.float32),
        label_targets=soft, targets=targets)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _bridge(tree):
    return {k: torch.tensor(np.asarray(v, np.float32))
            for k, v in state_dict_from_jax_params(
                jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
            ).items()}


def _jax_model():
    return JaxPretrain(jax_tiny(**NO_DROP), img_dim=IMG_DIM,
                       img_label_dim=LABEL_DIM)


def _jax_params(seed=0):
    params = _jax_model().init({"params": jax.random.PRNGKey(seed)},
                               _jb(_batch()),
                               method=JaxPretrain.init_all)["params"]
    rng = np.random.RandomState(seed + 1)
    return jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, x.shape)).astype(
            np.float32), jax.tree.map(np.asarray, dict(params)))


def _port_model(params, **cfg):
    model = UniterForPretraining(pconfig.tiny_config(**{**NO_DROP, **cfg}),
                                 img_dim=IMG_DIM, img_label_dim=LABEL_DIM)
    model.load_state_dict(_bridge(params), strict=True)
    return model


@pytest.fixture(scope="module")
def pair():
    params = _jax_params()
    return SimpleNamespace(jmodel=_jax_model(), params=params,
                           model=_port_model(params), batch=_batch())


# ------------------------------------------------------------- the bridge

def test_bridge_matches_export_state_dict(pair):
    ours = state_dict_from_jax_params(pair.params)
    theirs = export_state_dict(pair.params)
    assert list(ours) == list(theirs)  # same keys, same order
    for k, v in theirs.items():
        assert ours[k].dtype == np.asarray(v).dtype
        assert np.array_equal(ours[k], np.asarray(v)), k
    sd = pair.model.state_dict()
    assert sorted(ours) == sorted(sd)
    for k in ("cls.predictions.bias", "cls.predictions.transform.dense.weight",
              "feat_regress.net.2.weight", "feat_regress.bias",
              "region_classifier.net.3.weight", "itm_output.weight"):
        assert k in sd
    # tied: no decoder or projection weight of the heads' own
    assert not [k for k in sd if "decoder" in k]
    assert sum(k.startswith("cls.") for k in sd) == 5
    assert sum(k.startswith("feat_regress.") for k in sd) == 5


def test_tied_weights_take_gradient_from_the_heads(pair):
    model, tb = pair.model, _tt(pair.batch)
    model.zero_grad()
    loss, _ = model.scalar_loss(tb, "mrfr", deterministic=True)
    loss.backward()
    g = model.uniter.img_embeddings.img_linear.weight.grad
    assert g is not None and g.abs().sum() > 0
    model.zero_grad()
    loss, _ = model.scalar_loss(tb, "mlm", deterministic=True)
    loss.backward()
    g = model.uniter.embeddings.word_embeddings.weight.grad
    # rows no input id reads still get gradient through the decoder
    unread = np.setdiff1d(np.arange(512), pair.batch["input_ids"])
    assert g[torch.from_numpy(unread)].abs().sum() > 0
    model.zero_grad()


# ------------------------------------------------- forward, loss, gradient

def _lam(task):
    return OT_LAMBDA if task.startswith("itm") else 0.0


@pytest.mark.parametrize("task", TASKS)
def test_task_logits_loss_and_grads_match_jax(pair, task):
    jb, tb = _jb(pair.batch), _tt(pair.batch)
    jmodel, model = pair.jmodel, pair.model
    want = jmodel.apply({"params": pair.params}, jb, task, False,
                        deterministic=True)
    got = model(tb, task, False, deterministic=True)
    if task == "itm":
        np.testing.assert_allclose(got[1].detach().numpy(),
                                   np.asarray(want[1]), rtol=1e-4, atol=1e-5)
        got, want = got[0], want[0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)

    def jloss(p):
        return jmodel.apply({"params": p}, jb, task, ot_lambda=_lam(task),
                            deterministic=True,
                            method=JaxPretrain.scalar_loss)

    (want_loss, want_metrics), grads = jax.value_and_grad(
        jloss, has_aux=True)(jax.tree.map(jnp.asarray, pair.params))
    want_grads = _bridge(grads)
    model.zero_grad()
    loss, metrics = model.scalar_loss(tb, task, ot_lambda=_lam(task),
                                      deterministic=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-4)
    assert sorted(metrics) == sorted(want_metrics) == (
        ["itm_ot", "itm_xe"] if task == "itm" else [task])
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        assert not metrics[k].requires_grad
    for k, p in model.named_parameters():
        ref = want_grads[k].numpy()
        grad = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
        np.testing.assert_allclose(
            grad, ref, atol=1e-4 * np.abs(ref).max() + 1e-6, rtol=0,
            err_msg=k)
    model.zero_grad()


def test_itm_without_ot_and_invalid_task(pair):
    tb = _tt(pair.batch)
    loss, metrics = pair.model.scalar_loss(tb, "itm", ot_lambda=0.0,
                                           deterministic=True)
    assert sorted(metrics) == ["itm_xe"] and float(loss) == float(
        metrics["itm_xe"])
    scores, ot_dist = pair.model.forward_itm(tb, False, False,
                                             deterministic=True)
    assert ot_dist is None and scores.shape == (4, 2)
    with pytest.raises(ValueError, match="invalid task"):
        pair.model(tb, "vqa")
    with pytest.raises(ValueError, match="ot_impl"):
        UniterForPretraining(pconfig.tiny_config(), ot_impl="auto")


def test_decay_mask_matches_jax(pair):
    from uniter_tpu.training import optim as jopt
    from uniter_tpu_torch.training import optim as popt

    flags = state_dict_from_jax_params(jax.tree.map(
        lambda leaf, f: np.full(np.shape(leaf), f), pair.params,
        jopt.decay_mask(pair.params)))
    got = popt.decay_mask(pair.model)
    assert sorted(got) == sorted(flags) == sorted(
        n for n, _ in pair.model.named_parameters())
    for k, v in flags.items():
        assert np.unique(v).size == 1, k
        assert bool(v.flat[0]) == got[k], k
    for k in ("cls.predictions.bias", "feat_regress.bias",
              "feat_regress.net.2.weight", "region_classifier.net.2.weight",
              "cls.predictions.transform.LayerNorm.weight"):
        assert not got[k], k
    for k in ("uniter.embeddings.word_embeddings.weight",
              "uniter.img_embeddings.img_linear.weight",
              "region_classifier.net.3.weight", "itm_output.weight"):
        assert got[k], k


# --------------------------------------------------------------- the data

MODEL_CFG = dict(vocab_size=300, hidden_size=48, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=96,
                 max_position_embeddings=64, type_vocab_size=2,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 hidden_act="gelu", initializer_range=0.02)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Two corpora of 12 texts over 6 images each (5-9 regions, soft labels
    [nbb, 1601]), written with the port's DB writers."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.txt_db import write_txt_db

    root = tmp_path_factory.mktemp("torch_pretrain")
    rng = np.random.RandomState(0)
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [104, 300]}
    for c in ("a", "b"):
        names = [f"{c}_{i:06d}.npz" for i in range(6)]
        imgs = {}
        for n in names:
            nbb = rng.randint(5, 10)
            soft = rng.rand(nbb, 1601).astype(np.float32)
            imgs[n] = dict(
                features=rng.randn(nbb, 2048).astype(np.float16),
                norm_bb=rng.rand(nbb, 6).astype(np.float16),
                conf=np.linspace(1, 0.3, nbb).astype(np.float16),
                soft_labels=(soft / soft.sum(-1, keepdims=True)).astype(
                    np.float16))
        write_img_db(str(root / f"img_{c}"), imgs, conf_th=0.2, max_bb=10,
                     min_bb=3)
        recs, t2i = {}, {}
        for i in range(12):
            recs[f"{c}_{i}"] = dict(
                input_ids=[int(x) for x in rng.randint(110, 300,
                                                       rng.randint(4, 10))],
                img_fname=names[i % 6])
            t2i[f"{c}_{i}"] = names[i % 6]
        write_txt_db(str(root / f"txt_{c}"), recs, meta, t2i)
    with open(root / "model.json", "w") as f:
        json.dump(MODEL_CFG, f)
    return root


def _datasets(dbs, lib, cls_name):
    """The dataset ``cls_name`` of corpus a in the JAX package (``lib``
    "jax") or the port."""
    import importlib

    pkg = "uniter_tpu" if lib == "jax" else "uniter_tpu_torch"
    mod = {"MlmDataset": "mlm", "MrfrDataset": "mrm", "MrcDataset": "mrm",
           "ItmDataset": "itm"}[cls_name]
    cls = getattr(importlib.import_module(f"{pkg}.data.{mod}"), cls_name)
    txt = importlib.import_module(f"{pkg}.data.txt_db").TxtTokDb(
        str(dbs / "txt_a"), max_txt_len=60)
    img = importlib.import_module(f"{pkg}.data.img_db").DetectFeatDb(
        str(dbs / "img_a"), conf_th=0.2, max_bb=10, min_bb=3, num_bb=36)
    if cls_name in ("MrfrDataset", "MrcDataset"):
        return cls(0.15, txt, img)
    return cls(txt, img)


def _same(a, b, where):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("cls_name", ["MlmDataset", "MrfrDataset",
                                      "MrcDataset", "ItmDataset"])
def test_dataset_records_and_collates_equal_jax(dbs, cls_name):
    jds, pds = (_datasets(dbs, lib, cls_name) for lib in ("jax", "port"))
    assert len(jds) == len(pds) == 12 and jds.lens == pds.lens
    if cls_name == "ItmDataset":
        for ds in (jds, pds):
            ds.new_epoch(np.random.RandomState(5))
        assert jds.train_imgs == pds.train_imgs
        assert list(jds.labels) == list(pds.labels)
        assert 0 < sum(pds.labels) < 12
    jrecs = [jds.get_record(i, np.random.RandomState(100 + i))
             for i in range(12)]
    precs = [pds.get_record(i, np.random.RandomState(100 + i))
             for i in range(12)]
    for i, (a, b) in enumerate(zip(jrecs, precs)):
        _same(a, b, f"record {i}")
        assert jds.size_of(i) == pds.size_of(i)
    # a full batch and one with collate padding rows
    for recs_j, recs_p, bs in ((jrecs[:8], precs[:8], 8),
                               (jrecs[8:], precs[8:], 8)):
        _same(type(jds).collate(recs_j, 16, 12, bs),
              type(pds).collate(recs_p, 16, 12, bs), f"collate {bs}")
    batch = type(pds).collate(precs[8:], 16, 12, 8)
    if cls_name == "ItmDataset":
        assert list(batch["targets"][4:]) == [-1] * 4
    if cls_name == "MrcDataset":
        assert batch["label_targets"].shape[-1] == 1601


# --------------------------------------------------------- the train step

def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("task", ["mlm", "mrfr", "itm", "mrc-kl"])
def test_train_steps_match_jax(task, accum):
    """Two steps of one task, dropout 0, ``loss_scale="sum"``, as the
    drivers build them; under accumulation the metrics are the mean over
    the micro-batches."""
    from uniter_tpu.training import optim as jopt
    from uniter_tpu.training import sched as jsched
    from uniter_tpu.training.step import TrainState as JaxState
    from uniter_tpu.training.step import make_train_step as jax_step
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training import sched as psched
    from uniter_tpu_torch.training import step as pstep

    feed = [_batch(seed=s) for s in range(2 * accum)]
    if accum == 2:
        feed = [_stack(feed[:2]), _stack(feed[2:])]
    jmodel, params = _jax_model(), _jax_params(seed=3)

    def jax_loss(p, batch, rng):
        return jmodel.apply({"params": p}, batch, task, ot_lambda=_lam(task),
                            deterministic=False, rngs={"dropout": rng},
                            method=JaxPretrain.scalar_loss)

    sched = (1e-3, 1, 4)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = JaxState.create(jp, jopt.build_optimizer(
        jp, jsched.get_lr_schedule(*sched), grad_norm=1.0, fused=True))
    jstep = jax_step(jax_loss, loss_scale="sum", accum_steps=accum,
                     donate=False)
    model = _port_model(params)
    state = pstep.TrainState(step=0, model=model, opt=popt.build_optimizer(
        model, psched.get_lr_schedule(*sched), grad_norm=1.0, fused=True))
    step = pstep.make_train_step(
        lambda m, b, g: m.scalar_loss(b, task, ot_lambda=_lam(task),
                                      deterministic=False, generator=g),
        loss_scale="sum", accum_steps=accum)
    for batch in feed:
        jstate, jm = jstep(jstate, _jb(batch), jax.random.PRNGKey(0))
        state, m = step(state, _tt(batch), 0)
        assert sorted(m) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert state.step == int(jstate.step) == 2
    want = _bridge(jstate.params)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


# ------------------------------------------------------------ the task mix

class _Counting:
    """An endless loader of numbered batches that can skip."""

    def __init__(self, name):
        self.name, self.next = name, 0

    def skip_batches(self, n):
        self.next += n

    def __iter__(self):
        while True:
            self.next += 1
            yield {"input_ids": np.zeros((2, 3), np.int32),
                   "attn_mask": np.ones((2, 3), np.int32),
                   "ex_weight": np.ones(2, np.float32),
                   "id": np.array([self.next])}


MIX = {"mlm_a": 2, "itm_a": 2, "mrfr_a": 1, "mrc-kl_a": 1}


def _meta(lib, seed):
    import importlib

    pkg = "uniter_tpu" if lib == "jax" else "uniter_tpu_torch"
    cls = importlib.import_module(f"{pkg}.data.loader").MetaLoader
    return cls({n: (_Counting(n), r) for n, r in MIX.items()}, seed=seed)


def test_meta_loader_and_mixed_task_loop_follow_jax_task_order():
    from uniter_tpu_torch.training.loop import (
        MixedTaskLoop, pretrain_loss_units)

    n = 40
    it = iter(_meta("jax", 9))
    want = [next(it) for _ in range(n)]
    it = iter(_meta("port", 9))
    got = [next(it) for _ in range(n)]
    assert [(a, int(b["id"][0])) for a, b in got] == [
        (a, int(b["id"][0])) for a, b in want]
    assert {a for a, _ in got} == set(MIX)

    def run(start, stop):
        seen = []
        state = SimpleNamespace(step=start)

        def get_step(task):
            def step(st, batch, seed):
                st.step += 1
                seen.append((task, int(batch["id"][0])))
                return st, {"loss": torch.tensor(0.5),
                            "grad_norm": torch.tensor(1.0)}
            return step

        loop = MixedTaskLoop(
            meta=_meta("port", 9), get_step=get_step, state=state,
            device="cpu", num_train_steps=stop, valid_steps=0, log_steps=7,
            seed=9, loss_units_fn=lambda t, b: 1, preempt=False)
        assert loop.run().step == stop
        return seen

    order = [(a.split("_")[0], int(b["id"][0])) for a, b in want]
    assert run(0, n) == order
    assert run(25, n) == order[25:]  # resume: the mix fast-forwarded
    assert pretrain_loss_units("mlm", {"mlm_tgt": np.array([[3, -1]])}) == 1
    assert pretrain_loss_units("mrc-kl",
                               {"mrm_valid": np.array([[1., 1., 0.]])}) == 2
    assert pretrain_loss_units("itm", {"ex_weight": np.ones(5)}) == 5


# ---------------------------------------------------------------- the CLI

def _opts(dbs, out, n, **kw):
    from uniter_tpu_torch import pretrain
    from uniter_tpu_torch.utils.misc import parse_with_config

    datasets = [{"name": c, "db": str(dbs / f"txt_{c}"),
                 "img": str(dbs / f"img_{c}"),
                 "tasks": ["mlm", "itm", "mrfr", "mrc-kl"],
                 "mix_ratio": [2, 2, 1, 1]} for c in ("a", "b")]
    conf = dict(model_config=str(dbs / "model.json"),
                output_dir=str(dbs / out), train_batch_size=256,
                val_batch_size=512, num_train_steps=n, valid_steps=100,
                log_steps=1, warmup_steps=2, max_bb=10, min_bb=3,
                dtype="float32", seed=11, n_workers=0, device="cpu",
                train_datasets=datasets, val_datasets=datasets[:1])
    conf.update(kw)
    path = str(dbs / f"{out}_{n}.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return path, parse_with_config(pretrain.get_parser(), ["--config", path])


def test_pretrain_cli_resume_equals_straight_run(dbs, caplog, monkeypatch):
    """4 steps straight against the same run preempted after step 2 and
    rerun (dropout 0.1, accumulation 2, all four tasks over two corpora):
    the rerun replays the task draws, the loaders' positions and the
    dropout masks, so weights and moments end bit for bit equal."""
    from uniter_tpu_torch import pretrain

    class PreemptAfter:
        """Stands in for the SIGTERM guard: asks to stop after n polls."""

        def __init__(self, n):
            self.left = n

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def poll(self):
            self.left -= 1
            return self.left == 0

    kw = dict(gradient_accumulation_steps=2)
    caplog.set_level(logging.INFO)
    straight = pretrain.main(_opts(dbs, "straight", 4, **kw)[1])
    assert straight.step == 4
    real = pretrain.MixedTaskLoop
    monkeypatch.setattr(pretrain, "MixedTaskLoop", lambda **k: real(
        **{**k, "preempt": PreemptAfter(2)}))
    part = pretrain.main(_opts(dbs, "resumed", 4, **kw)[1])
    assert part.step == 2
    monkeypatch.setattr(pretrain, "MixedTaskLoop", real)
    resumed = pretrain.main(_opts(dbs, "resumed", 4, **kw)[1])
    assert resumed.step == 4
    log = caplog.text
    assert "preempted at step 2/4" in log
    assert "resumed from step 2" in log
    assert "fast-forwarded task mix by 2 steps" in log
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    ma, mb = straight.opt.state(), resumed.opt.state()
    for which in ("mu", "nu"):
        for k in ma[which]:
            assert torch.equal(ma[which][k], mb[which][k]), k
    assert straight.opt.count == resumed.opt.count == 4


def test_pretrain_module_entry_trains_validates_and_saves(dbs):
    path, _ = _opts(dbs, "entry", 2, valid_steps=2)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "uniter_tpu_torch.pretrain", "--config", path,
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ot xla" in proc.stderr and "device: cpu" in proc.stderr
    out = dbs / "entry"
    assert {"model_step_2.pt", "train_state_2.pt"} <= set(
        os.listdir(out / "ckpt"))
    scalars = {}
    for line in open(out / "log" / "scalars.jsonl"):
        scalars.update(json.loads(line))
    for key in ("valid/mlm_a_acc", "valid/mrfr_a_loss", "valid/mrc-kl_a_acc",
                "valid/itm_a_acc"):
        assert np.isfinite(scalars[key]), key
    assert any(k.startswith("loss/") for k in scalars)
    assert any(k.endswith("_loss_per_s") for k in scalars)
    # the saved weights are the bridge's key set: they load strictly
    sd = torch.load(out / "ckpt" / "model_step_2.pt", weights_only=True)
    model = UniterForPretraining(
        pconfig.UniterConfig.from_dict(MODEL_CFG), img_dim=2048)
    model.load_state_dict(sd, strict=True)


def test_head_checkpoint_round_trip_and_shape_rules(pair, tmp_path):
    """``--checkpoint`` restores trunk and pretraining heads; a head tensor
    of another shape is skipped with a warning, a trunk tensor raises."""
    from uniter_tpu_torch.pretrain import load_pretrain_heads
    from uniter_tpu_torch.training.driver import load_trunk_checkpoint
    from uniter_tpu_torch.utils.logger import LOGGER

    sd = {k: v.clone() for k, v in pair.model.state_dict().items()}
    path = str(tmp_path / "pretrained.pt")
    torch.save(sd, path)
    opts = SimpleNamespace(checkpoint=path)

    def fresh():
        torch.manual_seed(1)
        return UniterForPretraining(pconfig.tiny_config(**NO_DROP),
                                    img_dim=IMG_DIM, img_label_dim=LABEL_DIM)

    model = load_trunk_checkpoint(fresh(), opts, extra=load_pretrain_heads)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k

    sd["region_classifier.net.3.weight"] = torch.zeros(7, 64)
    torch.save(sd, path)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    LOGGER.addHandler(handler)
    try:
        model = load_trunk_checkpoint(fresh(), opts,
                                      extra=load_pretrain_heads)
    finally:
        LOGGER.removeHandler(handler)
    assert any("region_classifier.net.3.weight" in r.getMessage()
               and "skipped" in r.getMessage() for r in records)
    want = fresh().state_dict()["region_classifier.net.3.weight"]
    got = model.state_dict()
    assert torch.equal(got["region_classifier.net.3.weight"], want)
    assert torch.equal(got["region_classifier.net.3.bias"],
                       sd["region_classifier.net.3.bias"])
    assert torch.equal(got["cls.predictions.bias"], sd["cls.predictions.bias"])

    sd["uniter.pooler.dense.weight"] = torch.zeros(5, 64)
    torch.save(sd, path)
    with pytest.raises(ValueError, match=r"uniter\.pooler\.dense\.weight.*"
                                         r"\(5, 64\).*\(64, 64\)"):
        load_trunk_checkpoint(fresh(), opts, extra=load_pretrain_heads)


# ------------------------------------------------------ over two processes

def test_pretrain_over_two_processes_with_fsdp(dbs):
    path, _ = _opts(dbs, "run_two", 4, valid_steps=2)
    run_cli("pretrain", ["--config", path, "--fsdp", "--fsdp_min_size",
                         "1000"])
    outs = run_cli("pretrain", ["--config", path, "--num_train_steps", "6"])
    assert any("resumed from step 4" in o for o in outs)
    assert "model_step_6.pt" in os.listdir(dbs / "run_two" / "ckpt")
    assert "valid/mlm_a_acc" in open(dbs / "run_two" / "log" /
                                     "scalars.jsonl").read()
