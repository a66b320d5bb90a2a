"""The port's training stack against the JAX package, on the CPU in fp32.

* Schedules: ``get_lr_schedule`` and the three shapes, count by count, to
  rtol 1e-6 (the JAX package evaluates them in fp32, the port in Python
  floats).
* Weight-decay and head masks: the JAX masks carried through the weight
  bridge (a leaf full of its flag) equal the port's, key for key.
* One to three AdamW updates on the same parameters and gradients: the JAX
  package's ``fused_adamw`` and the port's ``FusedAdamW`` agree to atol =
  rtol = 1e-6 in the parameters, as tests/test_optim_parity.py holds the
  JAX optimizers to each other; moments to 1e-6 of the leaf's largest
  entry (the clip factor's last fp32 bit, where mu's two terms cancel),
  bf16 moments also to one bf16 step (an fp32 difference of one ulp can
  round either way, and then that element's update moves by up to a bf16
  step: such elements are held to 1e-3).
* 20 train steps of the tiny VQA model, dropout 0, ``loss_scale="sum"``,
  canned batches of two bucket shapes, accumulation 1 and 2: per-step loss
  and gradient norm to rtol 1e-5 and the final parameters to atol 1e-5
  (another summation order through the layers, then 20 Adam steps at lr up
  to 1e-2 on the head).
* A resumed run at dropout 0.1 replays the masks: 6 steps and 3 + save +
  restore + 3 end with bitwise equal parameters and moments.
* The CLI: ``python -m uniter_tpu_torch.train_vqa --device cpu`` trains,
  validates, saves; a rerun resumes; the port's ``inf_vqa`` answers from its
  directory; and a longer run learns a small image-determined answer set.
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

from uniter_tpu.config import tiny_config as jax_tiny
from uniter_tpu.models.vqa import UniterForVisualQuestionAnswering as JaxVqa
from uniter_tpu.training import optim as jopt
from uniter_tpu.training import sched as jsched
from uniter_tpu.training.step import TrainState as JaxState
from uniter_tpu.training.step import make_train_step as jax_make_train_step
from uniter_tpu_torch import config as pconfig
from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
from uniter_tpu_torch.train_vqa import vqa_loss
from uniter_tpu_torch.training import infer
from uniter_tpu_torch.training import optim as popt
from uniter_tpu_torch.training import sched as psched
from uniter_tpu_torch.training import step as pstep
from uniter_tpu_torch.utils.save import TrainStateSaver

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
torch.set_num_threads(2)

IMG_DIM = 32
N_ANS = 11
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _batch(b, t, r, seed):
    rng = np.random.RandomState(seed)
    attn = np.ones((b, t + r), np.int32)
    attn[0, t - 2:t] = 0
    attn[1, t + r - 2:] = 0
    weight = np.ones(b, np.float32)
    weight[-1] = 0.0  # a collate padding row
    return dict(
        input_ids=rng.randint(1, 500, (b, t)).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        img_feat=rng.randn(b, r, IMG_DIM).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=attn,
        targets=(rng.rand(b, N_ANS) < 0.2).astype(np.float32)
        * rng.rand(b, N_ANS).astype(np.float32),
        ex_weight=weight)


# two bucket shapes, alternating
BATCHES = [_batch(4, 8, 6, 0), _batch(4, 12, 5, 1), _batch(4, 8, 6, 2),
           _batch(4, 12, 5, 3)]


@pytest.fixture(scope="module")
def jax_params():
    model = JaxVqa(jax_tiny(**NO_DROP), img_dim=IMG_DIM, num_answer=N_ANS)
    b = {k: jnp.asarray(v) for k, v in BATCHES[0].items()}
    params = model.init({"params": jax.random.PRNGKey(0)}, b, False)["params"]
    rng = np.random.RandomState(1)
    return jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, x.shape)).astype(
            np.float32), jax.tree.map(np.asarray, dict(params)))


def _bridge(tree):
    return {k: torch.tensor(np.asarray(v, np.float32))
            for k, v in state_dict_from_jax_params(
                jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
            ).items()}


def _port_model(params, **cfg):
    model = UniterForVisualQuestionAnswering(
        pconfig.tiny_config(**cfg), img_dim=IMG_DIM, num_answer=N_ANS)
    model.load_state_dict(_bridge(params), strict=True)
    return model


def _tt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("lr,warm,total", [(8e-5, 600, 6000), (3e-5, 0, 50),
                                           (1e-3, 7, 7)])
def test_lr_schedule_matches_jax(lr, warm, total):
    counts = sorted(set(range(0, 40)) | {warm - 1, warm, warm + 1, total - 1,
                                         total, total + 5} - {-1})
    want = [float(jsched.get_lr_schedule(lr, warm, total)(jnp.int32(c)))
            for c in counts]
    got = [psched.get_lr_schedule(lr, warm, total)(c) for c in counts]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_schedule_shapes_match_jax():
    for s in (1, 3, 399, 4000, 4001, 9000):
        np.testing.assert_allclose(psched.noam_schedule(s, 4000),
                                   float(jsched.noam_schedule(s, 4000)),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            psched.warmup_linear(s, 500, 6000),
            float(jsched.warmup_linear(s, 500, 6000)), rtol=1e-6)
        np.testing.assert_allclose(
            psched.vqa_schedule(s, 1000, 2000, 5000, 0.2),
            float(jsched.vqa_schedule(s, 1000, 2000, 5000, 0.2)), rtol=1e-6)


# ---------------------------------------------------------------- masks

@pytest.mark.parametrize("which", ["decay", "head"])
def test_masks_match_jax_through_the_bridge(jax_params, which):
    if which == "decay":
        jmask = jopt.decay_mask(jax_params)
    else:
        jmask = jopt.head_mask(jax_params, ("vqa_",))
    flags = state_dict_from_jax_params(jax.tree.map(
        lambda leaf, f: np.full(np.shape(leaf), f), jax_params, jmask))
    model = _port_model(jax_params, **NO_DROP)
    names = [n for n, _ in model.named_parameters()]
    got = (popt.decay_mask(model) if which == "decay"
           else popt.head_mask(names, ("vqa_",)))
    assert sorted(got) == sorted(flags) == sorted(names)
    for k, v in flags.items():
        assert np.unique(v).size == 1, k
        assert bool(v.flat[0]) == got[k], k
    if which == "decay":
        assert got["vqa_output.0.weight"] and not got["vqa_output.2.weight"]
        assert got["uniter.img_embeddings.mask_embedding.weight"]


# ---------------------------------------------------------------- AdamW

@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_norm,lr_mul", [(0.0, 1.0), (0.5, 10.0)])
def test_fused_adamw_matches_jax(jax_params, moments, grad_norm, lr_mul):
    rng = np.random.RandomState(2)
    grads = [jax.tree.map(lambda p: (rng.randn(*np.shape(p)) * 0.1)
                          .astype(np.float32), jax_params) for _ in range(3)]
    sched_args = (1e-2, 2, 10)
    jdt = jnp.bfloat16 if moments == "bfloat16" else None
    tx = jopt.build_optimizer(
        jax.tree.map(jnp.asarray, jax_params),
        jsched.get_lr_schedule(*sched_args), grad_norm=grad_norm,
        lr_mul=lr_mul, lr_mul_paths=("vqa_",), fused=True, mu_dtype=jdt,
        nu_dtype=jdt)
    jstate = JaxState.create(jax.tree.map(jnp.asarray, jax_params), tx)

    model = _port_model(jax_params, **NO_DROP)
    pdt = torch.bfloat16 if moments == "bfloat16" else None
    opt = popt.build_optimizer(
        model, psched.get_lr_schedule(*sched_args), grad_norm=grad_norm,
        lr_mul=lr_mul, lr_mul_paths=("vqa_",), fused=True, mu_dtype=pdt,
        nu_dtype=pdt)
    params = dict(model.named_parameters())
    step_tol = 2.0 ** -7 if moments == "bfloat16" else 1e-6
    flipped = {k: np.zeros(p.shape, bool) for k, p in params.items()}
    for g in grads:
        jstate = jstate.apply_gradients(jax.tree.map(jnp.asarray, g))
        for k, v in _bridge(g).items():
            params[k].grad = v.clone()
        opt.step()
        for which in ("mu", "nu"):
            wm = _bridge(getattr(jstate.opt_state, which))
            for k, m in opt.state()[which].items():
                got, want = m.float().numpy(), wm[k].numpy()
                np.testing.assert_allclose(
                    got, want, rtol=step_tol,
                    atol=1e-6 * np.abs(want).max(), err_msg=f"{which} {k}")
                flipped[k] |= got != want
        want = _bridge(jstate.params)
        for k, p in params.items():
            # where a bf16 moment rounded to the neighbouring value, that
            # element's update moves by up to a bf16 step (2**-8) of
            # lr * lr_mul * |u| <= 1e-1 * O(1): held to 1e-3 there
            tol = np.where(flipped[k] & (moments == "bfloat16"), 1e-3, 1e-6)
            diff = np.abs(p.detach().numpy() - want[k].numpy())
            assert (diff <= tol + 1e-6 * np.abs(want[k].numpy())).all(), k
        np.testing.assert_allclose(float(opt.gnorm),
                                   float(jstate.opt_state.gnorm), rtol=1e-6)
        assert all(p.grad is None for p in params.values())


# ---------------------------------------------------------------- train step

def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(jax_params, accum):
    n_steps = 20 if accum == 1 else 10
    sched_args = (1e-3, 4, n_steps)
    if accum == 1:
        feed = [BATCHES[i % 4] for i in range(n_steps)]
    else:  # same-shape pairs
        feed = [_stack([BATCHES[i % 4], BATCHES[(i + 2) % 4]])
                for i in range(n_steps)]

    jmodel = JaxVqa(jax_tiny(**NO_DROP), img_dim=IMG_DIM, num_answer=N_ANS)

    def jax_loss(p, batch, rng):
        per_elem = jmodel.apply({"params": p}, batch, True,
                                deterministic=False, rngs={"dropout": rng})
        w = batch["ex_weight"][:, None]
        return (jnp.sum(per_elem * w)
                / jnp.maximum(jnp.sum(w) * N_ANS, 1.0)) * N_ANS, {}

    jp = jax.tree.map(jnp.asarray, jax_params)
    tx = jopt.build_optimizer(jp, jsched.get_lr_schedule(*sched_args),
                              grad_norm=1.0, lr_mul=10.0,
                              lr_mul_paths=("vqa_",), fused=True)
    jstate = JaxState.create(jp, tx)
    jstep = jax_make_train_step(jax_loss, loss_scale="sum",
                                accum_steps=accum, donate=False)

    model = _port_model(jax_params, **NO_DROP)
    opt = popt.build_optimizer(model, psched.get_lr_schedule(*sched_args),
                               grad_norm=1.0, lr_mul=10.0,
                               lr_mul_paths=("vqa_",), fused=True)
    state = pstep.TrainState(step=0, model=model, opt=opt)
    step = pstep.make_train_step(
        lambda m, b, g: (vqa_loss(m, b, g, N_ANS), {}), loss_scale="sum",
        accum_steps=accum)
    for batch in feed:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jax.random.PRNGKey(0))
        state, m = step(state, _tt(batch), 0)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert state.step == int(jstate.step) == n_steps
    want = _bridge(jstate.params)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_resume_replays_dropout_bitwise(tmp_path):
    """6 steps at dropout 0.1 against 3 steps, save, a fresh model and
    optimizer restored from disk, and 3 more: bitwise equal."""

    def fresh():
        torch.manual_seed(0)
        model = UniterForVisualQuestionAnswering(
            pconfig.tiny_config(), img_dim=IMG_DIM, num_answer=N_ANS)
        opt = popt.build_optimizer(
            model, psched.get_lr_schedule(1e-3, 2, 6), fused=True,
            mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16)
        return pstep.TrainState(step=0, model=model, opt=opt)

    step = pstep.make_train_step(
        lambda m, b, g: (vqa_loss(m, b, g, N_ANS), {}))

    def run(state, until):
        while state.step < until:
            state, _ = step(state, _tt(BATCHES[state.step % 4]), seed=7)
        return state

    straight = run(fresh(), 6)
    first = run(fresh(), 3)
    saver = TrainStateSaver(str(tmp_path))
    saver.save(3, first, seed=7)
    resumed = fresh()
    assert saver.restore(resumed) is resumed and resumed.step == 3
    run(resumed, 6)
    for (k, a), (_, b) in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), k
    sa, sb = straight.opt.state(), resumed.opt.state()
    assert sa["count"] == sb["count"] == 6
    for which in ("mu", "nu"):
        for k in sa[which]:
            assert torch.equal(sa[which][k], sb[which][k]), (which, k)
    # the masks are live: another seed gives another loss
    losses = [float(step(fresh(), _tt(BATCHES[0]), seed=s)[1]["loss"])
              for s in (7, 7, 8)]
    assert losses[0] == losses[1] != losses[2]


def test_steps_per_call_and_accumulation_stack_batches():
    """``steps_per_call`` 2 on a stacked [2, B, ...] batch is two single
    steps, bit for bit, losses stacked [2]; accumulation 2 on the same
    stack is one step on the summed gradients, whose loss is the mean of
    the two micro-batch losses."""

    def fresh():
        torch.manual_seed(0)
        model = UniterForVisualQuestionAnswering(
            pconfig.tiny_config(), img_dim=IMG_DIM, num_answer=N_ANS)
        opt = popt.build_optimizer(model, psched.get_lr_schedule(1e-3, 2, 6))
        return pstep.TrainState(step=0, model=model, opt=opt)

    def loss(m, b, g):
        return vqa_loss(m, b, g, N_ANS), {}

    pair = [BATCHES[0], BATCHES[2]]
    single = pstep.make_train_step(loss)
    a = fresh()
    want = [float(single(a, _tt(b), seed=3)[1]["loss"]) for b in pair]
    b = fresh()
    b, m = pstep.make_train_step(loss, steps_per_call=2)(
        b, _tt(_stack(pair)), seed=3)
    assert b.step == 2 and m["loss"].shape == (2,)
    assert m["loss"].tolist() == want
    for (k, x), (_, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(x, y), k
    c = fresh()
    c, m = pstep.make_train_step(loss, accum_steps=2)(
        c, _tt(_stack(pair)), seed=3)
    assert c.step == 1 and c.opt.count == 1
    gen = pstep.step_generator(3, 0)
    with torch.no_grad():
        micro = [float(loss(fresh().model, _tt(bt), gen)[0]) for bt in pair]
    np.testing.assert_allclose(float(m["loss"]), np.mean(micro), rtol=1e-6)


def test_trunk_checkpoint_loads_into_a_fresh_model(tmp_path):
    """``--checkpoint``: a reference-layout ``.pt`` (gamma/beta names, fp16
    values, ``uniter.`` prefix) fills the trunk; the head keeps its init."""
    from types import SimpleNamespace

    from uniter_tpu_torch.training.driver import load_trunk_checkpoint

    torch.manual_seed(0)
    src = UniterForVisualQuestionAnswering(
        pconfig.tiny_config(), img_dim=IMG_DIM, num_answer=N_ANS)
    sd = {k.replace("LayerNorm.weight", "LayerNorm.gamma"):
          (v.half() if i % 3 == 0 else v)
          for i, (k, v) in enumerate(src.state_dict().items())}
    torch.save(sd, str(tmp_path / "ref.pt"))
    torch.manual_seed(1)
    dst = UniterForVisualQuestionAnswering(
        pconfig.tiny_config(), img_dim=IMG_DIM, num_answer=N_ANS)
    head = dst.vqa_output[0].weight.clone()
    load_trunk_checkpoint(dst, SimpleNamespace(checkpoint=str(
        tmp_path / "ref.pt")))
    for k, got in dst.uniter.state_dict().items():
        ref = sd["uniter." + k.replace("LayerNorm.weight", "LayerNorm.gamma")]
        assert torch.equal(got, ref.float()), k
    assert torch.equal(dst.vqa_output[0].weight, head)


# ---------------------------------------------------------------- the CLI

N_CLI_ANS = 7
MODEL_CFG = dict(vocab_size=300, hidden_size=48, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=96,
                 max_position_embeddings=64, type_vocab_size=2,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 hidden_act="gelu", initializer_range=0.02)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Six images whose features decide the answer (image i answers i), 24
    questions, written with the port's DB writers."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.txt_db import write_txt_db

    root = tmp_path_factory.mktemp("torch_train")
    rng = np.random.RandomState(0)
    names = [f"coco_{i:06d}.npz" for i in range(6)]
    imgs = {}
    for i, n in enumerate(names):
        nbb = rng.randint(5, 10)
        feat = rng.randn(nbb, 2048).astype(np.float32) * 0.1
        feat[:, i * 8:(i + 1) * 8] += 3.0
        imgs[n] = dict(features=feat.astype(np.float16),
                       norm_bb=rng.rand(nbb, 6).astype(np.float16),
                       conf=np.linspace(1, 0.3, nbb).astype(np.float16),
                       soft_labels=rng.rand(nbb, 1601).astype(np.float16))
    write_img_db(str(root / "img"), imgs, conf_th=0.2, max_bb=10, min_bb=3)
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [104, 300]}
    recs, t2i = {}, {}
    for i in range(24):
        recs[f"q_{i}"] = dict(
            input_ids=[int(x) for x in rng.randint(110, 300,
                                                   rng.randint(4, 10))],
            img_fname=names[i % 6],
            target={"labels": [i % 6], "scores": [1.0]})
        t2i[f"q_{i}"] = names[i % 6]
    write_txt_db(str(root / "txt"), recs, meta, t2i)
    with open(root / "model.json", "w") as f:
        json.dump(MODEL_CFG, f)
    return root


def _train_config(dbs, out, **kw):
    cfg = dict(train_txt_db=str(dbs / "txt"), train_img_db=str(dbs / "img"),
               val_txt_db=str(dbs / "txt"), val_img_db=str(dbs / "img"),
               model_config=str(dbs / "model.json"), output_dir=str(out),
               num_answer=N_CLI_ANS, train_batch_size=256,
               val_batch_size=512, max_bb=10, min_bb=3, num_bb=36,
               n_workers=0, warmup_steps=2, valid_steps=2, log_steps=1,
               num_train_steps=3, device="cpu")
    cfg.update(kw)
    path = str(out) + ".json"
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _run(args):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_vqa_cli_trains_resumes_and_answers(dbs):
    out = dbs / "run"
    conf = _train_config(dbs, out)
    proc = _run(["-m", "uniter_tpu_torch.train_vqa", "--config", conf,
                 "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    ckpt = out / "ckpt"
    assert {"model_step_2.pt", "model_step_3.pt", "train_state_3.pt"} <= set(
        os.listdir(ckpt))
    scalars = [json.loads(line) for line in open(out / "log" /
                                                 "scalars.jsonl")]
    assert any("valid/score" in s for s in scalars)
    assert sum("loss" in s for s in scalars) == 3

    proc = _run(["-m", "uniter_tpu_torch.train_vqa", "--config", conf,
                 "--device", "cpu", "--num_train_steps", "5"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed from step 3" in proc.stderr
    assert "model_step_5.pt" in os.listdir(ckpt)
    assert infer.resolve_ckpt(str(out)).endswith("model_step_5.pt")

    proc = _run(["-m", "uniter_tpu_torch.inf_vqa", "--txt_db",
                 str(dbs / "txt"), "--img_db", str(dbs / "img"),
                 "--train_dir", str(out), "--output_dir", str(dbs / "ans"),
                 "--device", "cpu", "--save_logits"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    answers = json.load(open(dbs / "ans" / "results.json"))
    assert sorted(a["question_id"] for a in answers) == sorted(
        f"q_{i}" for i in range(24))
    logits = np.load(dbs / "ans" / "logits.npz")
    assert all(np.isfinite(logits[k].astype(np.float32)).all()
               and logits[k].shape == (N_CLI_ANS,) for k in logits.files)


def test_train_vqa_learns(dbs):
    """The VQA case of tests/test_e2e_learning.py at tiny size: 120 steps
    in fp32 with dropout 0.1; the loss falls and the trained model answers
    >= 90% of the training questions right."""
    from uniter_tpu_torch import inf_vqa, train_vqa
    from uniter_tpu_torch.utils.misc import parse_with_config

    out = dbs / "learn"
    conf = _train_config(dbs, out, num_train_steps=120, valid_steps=1000,
                         log_steps=10, learning_rate=3e-3, warmup_steps=10,
                         dtype="float32")
    state = train_vqa.main(parse_with_config(
        train_vqa.get_parser(), ["--config", conf]))
    assert state.step == 120
    losses = [s["loss"] for s in map(json.loads,
                                     open(out / "log" / "scalars.jsonl"))
              if "loss" in s]
    assert losses[-1] < 0.5 * losses[0], losses
    res = inf_vqa.main(inf_vqa.get_parser().parse_args([
        "--txt_db", str(dbs / "txt"), "--img_db", str(dbs / "img"),
        "--train_dir", str(out), "--output_dir", str(dbs / "learn_ans"),
        "--device", "cpu"]))
    answers = json.load(open(res))
    acc = np.mean([int(a["answer"]) == int(a["question_id"][2:]) % 6
                   for a in answers])
    assert acc >= 0.9, acc


def test_resolve_ckpt_prefers_newer_step_across_formats(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    for f in ("model_step_4.msgpack", "model_step_6.pt", "model_step_5.pt",
              "train_state_6.pt"):
        (d / f).write_bytes(b"")
    assert infer.resolve_ckpt(str(tmp_path)).endswith("model_step_6.pt")
    (d / "model_step_9.msgpack").write_bytes(b"")
    assert infer.resolve_ckpt(str(tmp_path)).endswith("model_step_9.msgpack")
    (d / "model_step_9.pt").write_bytes(b"")
    assert infer.resolve_ckpt(str(tmp_path)).endswith("model_step_9.pt")
    assert infer.resolve_ckpt(str(tmp_path), "4").endswith(
        "model_step_4.msgpack")
    with pytest.raises(FileNotFoundError):
        infer.resolve_ckpt(str(tmp_path), "7")
