"""The port's multi-process data parallelism (``uniter_tpu_torch/parallel``)
on the CPU: processes joined over gloo, each started with the variables
``torchrun`` sets, 2 torch threads each, ``tiny_config`` widths.

* Collectives at world sizes 2 and 4: picklable payloads of unequal size,
  the array gather, the barrier, the in-place and the detached sums,
  reduce-scatter and the all-gather of flat buffers (fp32 and bf16 bit for
  bit), the retrieval row gather over a count the world does not divide,
  the loop's host counts summed over ranks.
* Placement rules: ``param_sharding_full`` of the port (TP over ``model``,
  FSDP over ``data``, both) equal the JAX package's ``PartitionSpec``s
  leaf by leaf through the weight bridge (a ``Dense`` kernel transposed, an
  encoder stack per layer). A ``model`` axis that does not divide the
  processes is refused (``test_torch_tp.py`` runs the grids).
* Training: 3 steps of the tiny VQA model at dropout 0 on 2 ranks, each on
  its block of the same global batches, against the port in one process
  and the JAX package's ``make_train_step`` on a 2-device CPU mesh with
  ``loss_scale="sum"``: losses to 1e-5 relative, parameters to 1e-5.
  ``--fsdp`` (every parameter of 64 elements or more sharded at rest),
  also in master mode with bf16 moments and at dropout 0.1, against the
  replicated ranks: losses and parameters to 1e-6. A batch whose padding
  rows all fall in rank 1's block passes with the global denominators and
  misses with per-rank means (the control).
* Dropout 0.1 at any world size: 2 and 4 ranks against one process at
  every step, replicated, ``--fsdp``, ``--fsdp`` in master mode with bf16
  moments and ``--fsdp --remat``: losses to 1e-6 relative, parameters to
  1e-6 of their largest (master mode against the one process's master
  run). The JAX package has the property the port is held to: its step on
  a 2-device mesh at dropout 0.1 equals its 1-device step (1e-5).
* ``--fsdp`` at rest: a rank's parameter bytes are at most its share of
  the sharded ones plus padding plus the replicated ones, at 2 and 4
  ranks, and after a step no sharded parameter holds more than its one
  placeholder element; validation gathers once (``local_params``) and
  matches the replicated model with ranks running different numbers of
  batches; a pretraining mix (MLM, ITM + OT, MRFR, MRC-kl) at 2 ranks with
  ``--fsdp``, other heads idle each step, equals one process.
* Every rank draws rank 0's (one process's) dropout stream, knowing its
  block of the batch; RE's negatives at world 2 are world 1's block.
* SIGTERM to one rank: both stop at the same agreed step with a save that
  restores.
* The CLI: ``train_vqa`` at dropout 0.1, at world 2 with ``--fsdp``
  resumed at world 1, and at world 1 resumed at world 2 with ``--fsdp``,
  both equal the run resumed at world 1 from world 1 (1e-5); ``inf_vqa`` at world 2 writes world 1's
  files;
  ``fast_score_matrix`` / ``fast_windowed_scores`` /
  ``inference_score_matrix`` at world 2 equal world 1 (1e-6).

The workers are this file run as a script (``python
tests/test_torch_parallel.py JOB OUT``); they import neither jax nor the
JAX package.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
HERE = os.path.abspath(__file__)
torch.set_num_threads(2)

IMG_DIM = 32
N_ANS = 11
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
SCHED = (1e-3, 2, 3)  # lr, warm-up, total: the 3 training steps


def global_batch(seed, b=8, t=8, r=6, pad_rows=(7,)):
    """A global batch of ``b`` rows; ``pad_rows`` are padding (ex_weight
    0)."""
    rng = np.random.RandomState(seed)
    attn = np.ones((b, t + r), np.int32)
    attn[0, t - 2:t] = 0
    attn[1, t + r - 2:] = 0
    weight = np.ones(b, np.float32)
    weight[list(pad_rows)] = 0.0
    return dict(
        input_ids=rng.randint(1, 500, (b, t)).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        img_feat=rng.randn(b, r, IMG_DIM).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=attn,
        targets=(rng.rand(b, N_ANS) < 0.2).astype(np.float32)
        * rng.rand(b, N_ANS).astype(np.float32),
        ex_weight=weight)


BATCHES = [global_batch(0), global_batch(1, t=12, r=5), global_batch(2)]
# every padding row in rank 1's block of a 2-rank split
UNEVEN = global_batch(3, pad_rows=(4, 5, 6))


def block(batch, rank, world):
    n = len(batch["ex_weight"]) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _tt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


DROP = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def port_model(init_path, **cfg):
    from uniter_tpu_torch import config as pconfig
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering

    model = UniterForVisualQuestionAnswering(
        pconfig.tiny_config(**{**NO_DROP, **cfg}), img_dim=IMG_DIM,
        num_answer=N_ANS)
    model.load_state_dict(torch.load(init_path, weights_only=True))
    return model


def local_vqa_loss(model, batch, generator):
    """The control: each rank's mean over its own block (per-rank
    denominators)."""
    per = model(batch, True, deterministic=False, generator=generator)
    w = batch["ex_weight"].float()[:, None]
    return (per * w).sum() / (w.sum() * N_ANS).clamp_min(1.0) * N_ANS


def train_run(init_path, batches, rank=0, world=1, loss="global", cfg=None,
              extra=None, **opt_kw):
    """(losses, grad norms, final fp32 parameters, optimizer state bytes)
    of ``len(batches)`` steps on this rank's blocks (model config
    overrides ``cfg``); ``extra`` (a dict) also gets what ``--fsdp``
    leaves at rest and the trained model."""
    from uniter_tpu_torch.train_vqa import vqa_loss
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training import sched as psched
    from uniter_tpu_torch.training import step as pstep

    model = port_model(init_path, **(cfg or {}))
    opt = popt.build_optimizer(model, psched.get_lr_schedule(*SCHED),
                               grad_norm=1.0, lr_mul=10.0,
                               lr_mul_paths=("vqa_",), fused=True, **opt_kw)
    state = pstep.TrainState(step=0, model=model, opt=opt)
    fn = vqa_loss if loss == "global" else local_vqa_loss
    step = pstep.make_train_step(
        lambda m, b, g: (fn(m, b, g, N_ANS) if loss == "global"
                         else fn(m, b, g), {}), loss_scale="sum")
    losses, norms = [], []
    for batch in batches:
        state, m = step(state, _tt(block(batch, rank, world)), 0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    if extra is not None:
        extra.update(at_rest(model, opt), model=model)
    params = {k: v.detach().float().clone()
              for k, v in model.state_dict().items()}
    params.update({k: v.clone() for k, v in opt.masters().items()})
    return losses, norms, params, opt.state_bytes()


def at_rest(model, opt):
    """What a rank holds at rest: its parameter bytes, the bound on them
    (the sharded bytes over the world size, a world's worth of padding a
    group, the replicated bytes), and whether any sharded parameter holds
    more than its one placeholder element."""
    from uniter_tpu_torch.parallel.collectives import num_processes
    from uniter_tpu_torch.parallel.fsdp import sharding_of

    world = num_processes()
    sharding = sharding_of(model)
    where = sharding.where if sharding else {}
    sizes = {n: p.numel() * p.element_size()
             for n, p in model.named_parameters()}
    sharded = sum(v for n, v in sizes.items() if n in where)
    groups = len(sharding.groups) if sharding else 0
    bound = (sharded / world + groups * world * 4
             + sum(v for n, v in sizes.items() if n not in where))
    full = [n for n, p in model.named_parameters()
            if n in where and p.untyped_storage().nbytes() > p.element_size()]
    return {"param_bytes": opt.param_bytes(), "bound": bound,
            "sharded_bytes": sharded, "full": full}


# ------------------------------------------------------------ the workers

def job_collectives(out):
    from uniter_tpu_torch.parallel import collectives as C
    from uniter_tpu_torch.training.loop import summed
    from uniter_tpu_torch.utils.itm_fast import gather_rows, my_rows

    world, rank = C.num_processes(), C.process_index()
    assert world == int(os.environ["WORLD_SIZE"]) and rank == int(
        os.environ["RANK"])
    got = C.all_gather_list({"rank": rank, "pad": "x" * (10 + rank * 1000)})
    assert [g["rank"] for g in got] == list(range(world))
    assert [len(g["pad"]) for g in got] == [10 + i * 1000
                                            for i in range(world)]
    arr = C.all_gather_array(np.full((3, 2), rank, np.float32))
    assert arr.shape == (world, 3, 2) and (arr[:, 0, 0] == range(world)).all()
    C.barrier()
    t = torch.full((5,), float(rank + 1))
    assert C.all_reduce_sum(t) is t
    assert (t == world * (world + 1) / 2).all()
    x = torch.tensor(float(rank), requires_grad=True)
    s = C.global_sum(x * 2)
    assert not s.requires_grad and float(x) == rank
    assert float(s) == world * (world - 1)
    flat = torch.arange(world * 3, dtype=torch.float32) * (rank + 1)
    part = C.reduce_scatter(torch.empty(3), flat)
    want = torch.arange(rank * 3, rank * 3 + 3, dtype=torch.float32)
    assert torch.equal(part, want * world * (world + 1) / 2)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn(4, generator=torch.Generator().manual_seed(rank))
        g = g.to(dtype)
        full = C.all_gather(torch.empty(4 * world, dtype=dtype), g)
        assert torch.equal(full[rank * 4:rank * 4 + 4], g)
        blocks = C.all_gather_list(g.float().numpy())
        assert torch.equal(full.float(), torch.from_numpy(
            np.concatenate(blocks)))
    # the loop's host counts: the ranks' own, summed (uneven on purpose)
    assert summed({"ex": rank + 1, ("in", "mlm"): 10 * rank}) == {
        "ex": world * (world + 1) // 2,
        ("in", "mlm"): 10 * world * (world - 1) // 2}
    n = 2 * world + 1  # not a multiple of the world size
    mine = np.stack([np.full(3, i, np.float32) for i in my_rows(n)])
    whole = gather_rows(mine, n)
    assert (whole[:, 0] == np.arange(n)).all(), whole
    with open(os.path.join(out, f"ok{rank}"), "w") as f:
        f.write("ok")


def job_train(out, init_path):
    from uniter_tpu_torch.parallel.collectives import (
        num_processes, process_index)

    world, rank = num_processes(), process_index()
    runs = {
        "replicated": train_run(init_path, BATCHES, rank, world),
        "fsdp": train_run(init_path, BATCHES, rank, world, fsdp=True,
                          fsdp_min_size=64),
        "master": train_run(init_path, BATCHES, rank, world, master=True,
                            mu_dtype=torch.bfloat16,
                            nu_dtype=torch.bfloat16),
        "master_fsdp": train_run(init_path, BATCHES, rank, world,
                                 master=True, mu_dtype=torch.bfloat16,
                                 nu_dtype=torch.bfloat16, fsdp=True,
                                 fsdp_min_size=64),
        "uneven": train_run(init_path, [UNEVEN] * 2, rank, world),
        "uneven_local": train_run(init_path, [UNEVEN] * 2, rank, world,
                                  loss="local"),
    }
    runs.update(dropout_runs(init_path, rank, world))
    torch.save(runs, os.path.join(out, f"train{rank}.pt"))


DROP_MODES = {  # name -> (model config, optimizer options) at dropout 0.1
    "replicated": ({}, {}),
    "fsdp": ({}, dict(fsdp=True, fsdp_min_size=64)),
    "fsdp_master": ({}, dict(fsdp=True, fsdp_min_size=64, master=True,
                             mu_dtype=torch.bfloat16,
                             nu_dtype=torch.bfloat16)),
    "fsdp_remat": (dict(remat=True), dict(fsdp=True, fsdp_min_size=64)),
}


def dropout_runs(init_path, rank, world):
    """Every ``DROP_MODES`` run at dropout 0.1 ("drop_<mode>"), with what
    it leaves at rest, and the validation outputs of the --fsdp model."""
    out = {}
    for mode, (cfg, kw) in DROP_MODES.items():
        extra = {}
        out[f"drop_{mode}"] = train_run(init_path, BATCHES, rank, world,
                                        cfg={**DROP, **cfg}, extra=extra,
                                        **kw)
        model = extra.pop("model")
        out[f"rest_{mode}"] = extra
        if mode == "fsdp":
            out["valid"] = validation(model, rank, world)
    return out


def validation(model, rank, world):
    """Predictions of the ranks' shares of 3 evaluation batches (rank 0
    gets two, rank 1 one: the counts differ), under ``local_params``, and
    once more through the per-unit gathers on one batch every rank runs."""
    from uniter_tpu_torch.parallel.fsdp import local_params

    model.eval()
    mine = [i for i in range(3) if i % world == rank]
    got = {}
    with torch.no_grad():
        with local_params(model):
            for i in mine:
                got[i] = model(_tt(BATCHES[i]), False).float()
        got["lockstep"] = model(_tt(BATCHES[0]), False).float()
    return got


def job_train_drop(out, init_path):
    from uniter_tpu_torch.parallel.collectives import (
        num_processes, process_index)

    rank = process_index()
    torch.save(dropout_runs(init_path, rank, num_processes()),
               os.path.join(out, f"drop{rank}.pt"))


PRE_TASKS = ("mlm", "itm", "mrfr", "mrc-kl")
PRE_LABELS = 11


def pretrain_batch(seed, b=8, t=8, r=6):
    """A global pretraining batch with every task's fields (3 MLM and 2
    MRM slots, ITM targets 1/0)."""
    rng = np.random.RandomState(seed)
    attn = np.ones((b, t + r), np.int32)
    attn[0, t - 3:t] = 0
    attn[5, t + r - 2:] = 0
    soft = rng.rand(b, 2, PRE_LABELS).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    mlm_tgt = rng.randint(1, 500, (b, 3)).astype(np.int32)
    mlm_tgt[:, 2] = -1
    valid = np.ones((b, 2), np.float32)
    valid[0, 1] = 0
    img_masks = np.zeros((b, r), np.int32)
    img_masks[:, 0] = 1
    return dict(
        input_ids=rng.randint(1, 500, (b, t)).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        img_feat=rng.randn(b, r, IMG_DIM).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=attn, img_masks=img_masks, ex_weight=np.ones(b, np.float32),
        mlm_pos=rng.randint(0, t, (b, 3)).astype(np.int32), mlm_tgt=mlm_tgt,
        mrm_pos=np.tile(np.array([0, 2], np.int32), (b, 1)), mrm_valid=valid,
        feat_targets=rng.randn(b, 2, IMG_DIM).astype(np.float32),
        label_targets=soft, targets=np.array([1, 0] * (b // 2), np.int32))


def pretrain_run(rank=0, world=1, fsdp=False):
    """(losses, final parameters) of one pretraining step a task of
    ``PRE_TASKS`` (ITM with the OT loss) at dropout 0.1 on this rank's
    blocks; each step leaves the other tasks' heads idle, which under
    --fsdp run nothing and take a zero gradient."""
    from uniter_tpu_torch import config as pconfig
    from uniter_tpu_torch.models.pretrain import UniterForPretraining
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training import step as pstep

    torch.manual_seed(0)
    model = UniterForPretraining(pconfig.tiny_config(**DROP),
                                 img_dim=IMG_DIM, img_label_dim=PRE_LABELS)
    opt = popt.build_optimizer(model, 1e-3, grad_norm=1.0, fused=True,
                               fsdp=fsdp, fsdp_min_size=64)
    state = pstep.TrainState(step=0, model=model, opt=opt)
    losses = []
    for i, task in enumerate(PRE_TASKS):
        step = pstep.make_train_step(
            lambda m, b, g, _t=task: m.scalar_loss(b, _t, ot_lambda=0.1,
                                                   generator=g))
        state, m = step(state, _tt(block(pretrain_batch(i), rank, world)), 7)
        losses.append(float(m["loss"]))
    return losses, {k: v.float().clone()
                    for k, v in model.state_dict().items()}


def job_pretrain(out):
    from uniter_tpu_torch.parallel.collectives import (
        num_processes, process_index)

    rank = process_index()
    torch.save({fsdp: pretrain_run(rank, num_processes(), fsdp=fsdp)
                for fsdp in (False, True)}, os.path.join(out, f"pre{rank}.pt"))


class ToyLoader:
    """Global batches forever; this rank's block of each."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world

    def __iter__(self):
        i = 0
        while True:
            yield block(BATCHES[i % len(BATCHES)], self.rank, self.world)
            i += 1


def job_sigterm(out, init_path):
    from uniter_tpu_torch.parallel.collectives import (
        num_processes, process_index)
    from uniter_tpu_torch.train_vqa import vqa_loss
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training.loop import TrainLoop
    from uniter_tpu_torch.training.preempt import PreemptionGuard
    from uniter_tpu_torch.training.step import TrainState
    from uniter_tpu_torch.utils.save import TrainStateSaver

    world, rank = num_processes(), process_index()
    PreemptionGuard.SYNC_EVERY = 2  # agree every other step
    model = port_model(init_path)
    state = TrainState(step=0, model=model, opt=popt.build_optimizer(
        model, 1e-3, fused=True, fsdp=True, fsdp_min_size=64))

    def loss_fn(m, batch, generator):
        if rank == 1 and state.step == 2:  # during the third step
            os.kill(os.getpid(), signal.SIGTERM)
        return vqa_loss(m, batch, generator, N_ANS), {}

    loop = TrainLoop(loss_fn=loss_fn, state=state,
                     train_loader=ToyLoader(rank, world), device="cpu",
                     num_train_steps=50, valid_steps=0, log_steps=100,
                     saver=TrainStateSaver(out), seed=3,
                     preempt=PreemptionGuard())
    state = loop.run()
    with open(os.path.join(out, f"stop{rank}.json"), "w") as f:
        json.dump({"step": state.step, "preempted": loop.preempted}, f)


def scoring(dbs):
    """(fast matrix, batched matrix, windowed rows) of a seeded tiny
    retrieval model over the retrieval DBs ``dbs``."""
    from uniter_tpu_torch import config as pconfig
    from uniter_tpu_torch.data.img_db import DetectFeatDb
    from uniter_tpu_torch.data.itm import ItmEvalDataset, ItmValDataset
    from uniter_tpu_torch.data.txt_db import TxtTokDb
    from uniter_tpu_torch.models.itm import UniterForImageTextRetrieval
    from uniter_tpu_torch.training.driver import init_weights
    from uniter_tpu_torch.utils.itm_eval import inference_score_matrix
    from uniter_tpu_torch.utils.itm_fast import (
        fast_score_matrix, fast_windowed_scores)

    torch.manual_seed(0)
    model = UniterForImageTextRetrieval(
        pconfig.tiny_config(vocab_size=300), img_dim=2048)
    init_weights(model, 0.1)
    model.eval()
    txt = TxtTokDb(os.path.join(dbs, "txt"), max_txt_len=60)
    img = DetectFeatDb(os.path.join(dbs, "img"), conf_th=0.2, max_bb=10,
                       min_bb=3)
    ev = ItmEvalDataset(txt, img, mini_batch_size=5)
    t_b, r_b = ev.bucket_hint()
    fast, _ = fast_score_matrix(model, ev, t_b, r_b, txt_tile=4,
                                img_tile=4, dtype="float32")
    batched, _ = inference_score_matrix(model.predict, ev, t_b, r_b, "cpu")
    val = ItmValDataset(txt, img, mini_batch_size=4)
    t_b, r_b = val.bucket_hint()
    win, _ = fast_windowed_scores(model, val, t_b, r_b, txt_chunk=3,
                                  dtype="float32")
    return fast, batched, win


def job_scoring(out, dbs):
    from uniter_tpu_torch.parallel.collectives import process_index

    fast, batched, win = scoring(dbs)
    np.savez(os.path.join(out, f"scores{process_index()}.npz"), fast=fast,
             batched=batched, win=win)


JOBS = {"collectives": job_collectives, "train": job_train,
        "train_drop": job_train_drop, "pretrain": job_pretrain,
        "sigterm": job_sigterm, "scoring": job_scoring}


# ------------------------------------------------------------ launching

def _free_port():
    """A free port below the kernel's ephemeral range (32768 and up on
    Linux): the gloo ranks of the other launches open many connections
    whose source ports come from that range, and one of them could take
    an ephemeral port between this check and rank 0's bind."""
    rng = np.random.default_rng()
    while True:
        port = int(rng.integers(20000, 32000))
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            continue
        finally:
            s.close()
        return port


def launch(argv, world, timeout=300):
    """Start ``world`` ranks of ``python argv...`` with torchrun's
    variables; returns the processes."""
    port = str(_free_port())
    procs = []
    for rank in range(world):
        # MKL_CBWR: MKL's reproducible mode, one code path for the run.
        # Without it MKL may pick another path from run to run, and on some
        # paths a row's product depends on the batch's row count, so a
        # rank's block stops matching the same rows in one process.
        # MKL_DYNAMIC off: the 2 threads asked for, even on a busy host
        # (MKL may otherwise take fewer, and split a sum another way).
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   OMP_NUM_THREADS="2", PYTHONPATH=ROOT, MKL_CBWR="AUTO",
                   MKL_DYNAMIC="FALSE")
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    procs[0].deadline = time.time() + timeout
    return procs


def wait(procs):
    """Every rank's output; fails with the output of a rank that failed."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(procs[0].deadline - time.time(), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return outs


def run_job(job, world, out, *args):
    return wait(launch([HERE, job, str(out), *map(str, args)], world))


# ------------------------------------------------------------ fixtures

@pytest.fixture(scope="module")
def init_path(tmp_path_factory):
    """The tiny VQA model's weights from the JAX package's init (perturbed),
    through the weight bridge."""
    import jax
    import jax.numpy as jnp
    from uniter_tpu.config import tiny_config as jax_tiny
    from uniter_tpu.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params

    model = UniterForVisualQuestionAnswering(
        jax_tiny(**NO_DROP), img_dim=IMG_DIM, num_answer=N_ANS)
    b = {k: jnp.asarray(v) for k, v in BATCHES[0].items()}
    params = model.init({"params": jax.random.PRNGKey(0)}, b, False)["params"]
    rng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, x.shape)).astype(
            np.float32), jax.tree.map(np.asarray, dict(params)))
    path = tmp_path_factory.mktemp("parallel") / "init.pt"
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in
                state_dict_from_jax_params(params).items()}, path)
    return path, params


@pytest.fixture(scope="module")
def two_ranks(init_path, tmp_path_factory):
    out = tmp_path_factory.mktemp("train2")
    run_job("train", 2, out, init_path[0])
    return [torch.load(out / f"train{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def one_rank(init_path):
    path = init_path[0]
    return {"replicated": train_run(path, BATCHES),
            "uneven": train_run(path, [UNEVEN] * 2),
            "drop_replicated": train_run(path, BATCHES, cfg=DROP),
            "drop_master": train_run(path, BATCHES, cfg=DROP, master=True,
                                     mu_dtype=torch.bfloat16,
                                     nu_dtype=torch.bfloat16)}


@pytest.fixture(scope="module")
def four_ranks(init_path, tmp_path_factory):
    out = tmp_path_factory.mktemp("train4")
    run_job("train_drop", 4, out, init_path[0])
    return [torch.load(out / f"drop{r}.pt", weights_only=False)
            for r in range(4)]


def _close(got, want, tol, tag):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=tol, rtol=0, err_msg=f"{tag} {k}")


# ------------------------------------------------------------ collectives

@pytest.mark.parametrize("world", [2, 4])
def test_collectives(tmp_path, world):
    run_job("collectives", world, tmp_path)
    assert sorted(os.listdir(tmp_path)) == [f"ok{r}" for r in range(world)]


def test_one_process_collectives_are_the_identity():
    from uniter_tpu_torch.parallel import collectives as C

    assert not C.is_distributed()
    assert (C.num_processes(), C.process_index()) == (1, 0)
    t = torch.ones(3)
    assert C.all_reduce_sum(t) is t and C.global_sum(t) is t
    assert C.all_gather_list({"a": 1}) == [{"a": 1}]
    assert C.all_gather_array(np.ones((2, 3))).shape == (1, 2, 3)
    assert C.init_distributed("cpu") == "cpu"  # no launcher variables


# ------------------------------------------------------------ placement

@pytest.mark.parametrize("model_axis,fsdp", [(2, False), (1, True),
                                             (2, True)])
def test_placement_rules_match_jax(init_path, model_axis, fsdp):
    """The port's specs equal the JAX package's leaf by leaf: a kernel's
    spec reversed for the [out, in] weight, a stack's without its layer
    axis."""
    import jax
    from uniter_tpu.models.checkpoint import flatten
    from uniter_tpu.parallel import mesh as jmesh
    from uniter_tpu_torch.models.checkpoint import reference_leaf
    from uniter_tpu_torch.parallel import mesh as pmesh

    data = 2
    jm = jmesh.make_mesh(jmesh.MeshConfig(data=data, model=model_axis),
                         devices=jax.devices()[:data * model_axis])
    cfg = dict(fsdp=fsdp, fsdp_min_size=100)
    want = flatten(jmesh.param_sharding_full(
        init_path[1], jm, jmesh.MeshConfig(**cfg)))
    model = port_model(init_path[0])
    got = pmesh.param_sharding_full(
        [(n, p.shape) for n, p in model.named_parameters()],
        pmesh.Mesh(data=data, model=model_axis), pmesh.MeshConfig(**cfg))
    n_sharded = 0
    for name, spec in got.items():
        path, kind, stacked = reference_leaf(name)
        leaf = flatten(init_path[1])[path]
        ref = tuple(want[path].spec) + (None,) * (
            leaf.ndim - len(want[path].spec))
        if stacked:
            ref = ref[1:]
        if kind == "linear_w":
            ref = ref[::-1]
        assert spec == ref, (name, spec, ref)
        n_sharded += "data" in spec or "model" in spec
    assert n_sharded > 10


def test_make_mesh_refuses_a_model_axis():
    """One process has no room for a model axis of 2: ``make_mesh``
    refuses it and says why (a grid of processes runs it,
    ``test_torch_tp.py``)."""
    from uniter_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    assert make_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="does not divide 1 processes"):
        make_mesh(MeshConfig(model=2))


# ------------------------------------------------------------ training

def test_two_ranks_match_one_process(two_ranks, one_rank):
    """The same losses and parameters; the gradient norm twice the one
    process's (``loss_scale="sum"`` scales by the world size, as the JAX
    step does; the clip at 1.0 takes both to the same update)."""
    want_l, want_n, want_p, _ = one_rank["replicated"]
    for rank in range(2):
        losses, norms, params, _ = two_ranks[rank]["replicated"]
        np.testing.assert_allclose(losses, want_l, rtol=1e-5)
        np.testing.assert_allclose(norms, 2 * np.asarray(want_n), rtol=1e-5)
        _close(params, want_p, 1e-5, f"rank {rank}")


def test_two_ranks_match_jax_two_device_mesh(two_ranks, init_path):
    import jax
    import jax.numpy as jnp
    from uniter_tpu.config import tiny_config as jax_tiny
    from uniter_tpu.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu.parallel.mesh import (
        MeshConfig, batch_sharding, make_mesh, replicate)
    from uniter_tpu.training import optim as jopt
    from uniter_tpu.training import sched as jsched
    from uniter_tpu.training.step import TrainState, make_train_step
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params

    jmodel = UniterForVisualQuestionAnswering(
        jax_tiny(**NO_DROP), img_dim=IMG_DIM, num_answer=N_ANS)

    def loss(p, batch, rng):
        per = jmodel.apply({"params": p}, batch, True, deterministic=False,
                           rngs={"dropout": rng})
        w = batch["ex_weight"][:, None]
        return (jnp.sum(per * w)
                / jnp.maximum(jnp.sum(w) * N_ANS, 1.0)) * N_ANS, {}

    mesh = make_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    params = jax.tree.map(jnp.asarray, init_path[1])
    tx = jopt.build_optimizer(params, jsched.get_lr_schedule(*SCHED),
                              grad_norm=1.0, lr_mul=10.0,
                              lr_mul_paths=("vqa_",), fused=True)
    state = jax.device_put(TrainState.create(params, tx), replicate(mesh))
    step = make_train_step(loss, mesh=mesh, loss_scale="sum", donate=False)
    bsh = batch_sharding(mesh)
    losses = []
    for batch in BATCHES:
        state, m = step(state, jax.device_put(
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.tree.map(lambda _: bsh, batch)), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    want = {k: torch.tensor(np.asarray(v)) for k, v in
            state_dict_from_jax_params(
                jax.tree.map(np.asarray, state.params)).items()}
    for rank in range(2):
        got_l, _, got_p, _ = two_ranks[rank]["replicated"]
        np.testing.assert_allclose(got_l, losses, rtol=1e-5)
        _close(got_p, want, 1e-5, f"rank {rank} vs jax")


def test_jax_two_device_mesh_at_dropout_matches_one_device(init_path):
    """The reference's property the port is held to: the JAX package's
    ``make_train_step`` at dropout 0.1 on a 2-device data mesh equals the
    same step on one device (losses 1e-5 relative, parameters 1e-5): its
    masks are drawn over the global batch, whatever the sharding."""
    import jax
    import jax.numpy as jnp
    from uniter_tpu.config import tiny_config as jax_tiny
    from uniter_tpu.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu.parallel.mesh import (
        MeshConfig, batch_sharding, make_mesh, replicate)
    from uniter_tpu.training import optim as jopt
    from uniter_tpu.training import sched as jsched
    from uniter_tpu.training.step import TrainState, make_train_step

    jmodel = UniterForVisualQuestionAnswering(
        jax_tiny(**DROP), img_dim=IMG_DIM, num_answer=N_ANS)

    def loss(p, batch, rng):
        per = jmodel.apply({"params": p}, batch, True, deterministic=False,
                           rngs={"dropout": rng})
        w = batch["ex_weight"][:, None]
        return (jnp.sum(per * w)
                / jnp.maximum(jnp.sum(w) * N_ANS, 1.0)) * N_ANS, {}

    runs = {}
    for n_dev in (1, 2):
        mesh = make_mesh(MeshConfig(data=n_dev), devices=jax.devices()[:n_dev])
        params = jax.tree.map(jnp.asarray, init_path[1])
        tx = jopt.build_optimizer(params, jsched.get_lr_schedule(*SCHED),
                                  grad_norm=1.0, lr_mul=10.0,
                                  lr_mul_paths=("vqa_",), fused=True)
        state = jax.device_put(TrainState.create(params, tx),
                               replicate(mesh))
        step = make_train_step(loss, mesh=mesh, loss_scale="mean",
                               donate=False)
        bsh = batch_sharding(mesh)
        losses = []
        for batch in BATCHES:
            state, m = step(state, jax.device_put(
                {k: jnp.asarray(v) for k, v in batch.items()},
                jax.tree.map(lambda _: bsh, batch)), jax.random.PRNGKey(3))
            losses.append(float(m["loss"]))
        runs[n_dev] = (losses, jax.tree.map(np.asarray, state.params))
    np.testing.assert_allclose(runs[2][0], runs[1][0], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(runs[2][1]), jax.tree.leaves(runs[1][1])):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_uneven_padding_needs_global_denominators(two_ranks, one_rank):
    """Padding rows 4-6 all in rank 1's block: the global denominators
    give the one-process run; per-rank means (the control) do not."""
    want_l, _, want_p, _ = one_rank["uneven"]
    losses, _, params, _ = two_ranks[0]["uneven"]
    np.testing.assert_allclose(losses, want_l, rtol=1e-5)
    _close(params, want_p, 1e-5, "global")
    bad_l, _, bad_p, _ = two_ranks[0]["uneven_local"]
    assert abs(bad_l[0] - want_l[0]) > 1e-3 * abs(want_l[0])
    assert max(float((bad_p[k] - want_p[k]).abs().max())
               for k in want_p) > 1e-4


@pytest.mark.parametrize("mode", ["fsdp", "master_fsdp", "drop_fsdp"])
def test_fsdp_matches_replicated(two_ranks, mode):
    """``--fsdp`` at 2 ranks (every parameter of 64 elements or more
    sharded) against the replicated ranks, plain, in master mode with
    bf16 moments, and at dropout 0.1; each rank keeps about half of the
    moments. (No parameter of the tiny model reaches master mode's 2**16
    elements, so there its fp32 masters are the parameters themselves,
    and the sharded run keeps a block of masters besides: no saving to
    check.)"""
    base = {"fsdp": "replicated", "master_fsdp": "master",
            "drop_fsdp": "drop_replicated"}[mode]
    for rank in range(2):
        want_l, want_n, want_p, want_bytes = two_ranks[rank][base]
        losses, norms, params, n_bytes = two_ranks[rank][mode]
        np.testing.assert_allclose(losses, want_l, rtol=1e-6)
        np.testing.assert_allclose(norms, want_n, rtol=1e-6)
        _close(params, want_p, 1e-6, f"{mode} rank {rank}")
        if mode != "master_fsdp":
            assert 0.45 * want_bytes < n_bytes < 0.6 * want_bytes, (
                n_bytes, want_bytes)


def test_rank0_dropout_stream_is_unchanged():
    """Every rank draws the one process's stream (rank 0's, a function of
    the seed and the step alone, as JAX's ``fold_in(rng, step)``); the
    generator names the rank's block of the batch, which sets the masks'
    row base. A micro-batch of a split accumulation has its own stream."""
    from uniter_tpu_torch.ops.dropout import batch_block
    from uniter_tpu_torch.training.step import step_generator

    def draws(gen):
        return torch.randint(0, 2 ** 31, (4,), generator=gen).tolist()

    for seed, step in ((0, 0), (42, 7)):
        mixed = np.random.SeedSequence([seed, step]).generate_state(1)
        single = torch.Generator().manual_seed(int(mixed[0]))
        assert draws(step_generator(seed, step)) == draws(single)
        for world in (2, 4):
            gens = [step_generator(seed, step, block=r, blocks=world)
                    for r in range(world)]
            assert [batch_block(g) for g in gens] == [
                (r, world) for r in range(world)]
            assert all(draws(g) == draws(step_generator(seed, step))
                       for g in gens)
        micro = [draws(step_generator(seed, step, i)) for i in range(4)]
        assert len({tuple(m) for m in micro}) == 4


@pytest.mark.parametrize("mode", list(DROP_MODES))
@pytest.mark.parametrize("world", [2, 4])
def test_ranks_at_dropout_match_one_process(two_ranks, four_ranks, one_rank,
                                            world, mode):
    """Dropout 0.1: every rank of 2 and 4 applies its block of the one
    process's masks, so each step's loss is the one process's (1e-6
    relative) and so are the parameters after the last step (1e-6 of
    their largest), replicated, ``--fsdp``, ``--fsdp --remat`` (against
    the one process without remat: remat replays the masks) and
    ``--fsdp`` in master mode with bf16 moments (against the one
    process's master run)."""
    ranks = two_ranks if world == 2 else four_ranks
    ref = one_rank["drop_master" if mode == "fsdp_master"
                   else "drop_replicated"]
    want_l, _, want_p, _ = ref
    scale = max(float(v.abs().max()) for v in want_p.values())
    for rank in range(world):
        losses, _, params, _ = ranks[rank][f"drop_{mode}"]
        np.testing.assert_allclose(losses, want_l, rtol=1e-6)
        if mode == "fsdp_master":
            _close_bf16_moments(params, want_p, 1e-6 * scale,
                                f"{mode} rank {rank}/{world}")
        else:
            _close(params, want_p, 1e-6 * scale,
                   f"{mode} rank {rank}/{world}")


# one bf16 step of a moment in every update: the learning rates of SCHED
# summed over the 3 steps, times the head multiplier, times 2**-8
BF16_MOMENT_STEP = 2.0**-8 * 3 * SCHED[0] * 10.0


def _close_bf16_moments(got, want, tol, tag):
    """bf16 moments round each moment once a step: a gradient summed in
    another order (the ranks' blocks against one batch, ~1e-7 relative)
    now and then lands a moment on the next bf16 value, and that
    parameter's update moves by up to one bf16 step of its moment.
    Every parameter within ``tol`` but at most 0.1% of the elements,
    and those within ``tol`` plus that step."""
    off = total = 0
    for k in want:
        d = (got[k] - want[k]).abs()
        off += int((d > tol).sum())
        total += d.numel()
        assert float(d.max()) <= tol + BF16_MOMENT_STEP, (tag, k)
    assert off <= 1e-3 * total, (tag, off, total)


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_holds_a_block_at_rest(two_ranks, four_ranks, world):
    """After the steps a rank's parameter bytes are at most the sharded
    bytes over the world size, plus a world's padding a group, plus the
    replicated parameters; no sharded parameter holds more than its one
    placeholder element; replicated, a rank holds every parameter."""
    ranks = two_ranks if world == 2 else four_ranks
    for rank in range(world):
        for mode in ("fsdp", "fsdp_master", "fsdp_remat"):
            rest = ranks[rank][f"rest_{mode}"]
            assert rest["full"] == [], (mode, rest["full"])
            assert rest["sharded_bytes"] > 0
            assert rest["param_bytes"] <= rest["bound"], (mode, rest)
        full = ranks[rank]["rest_replicated"]
        fsdp = ranks[rank]["rest_fsdp"]
        assert fsdp["param_bytes"] < (1 / world + 0.1) * full["param_bytes"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fsdp_frees_each_units_gather_after_its_forward(init_path, dtype):
    """Under ``--fsdp`` (one process; fp32 compute, or bf16 over fp32
    parameters) every buffer a unit's forward gathers is freed once the
    forward is done: what autograd saved of it (the weight, its transpose,
    a view of its bf16 cast) is a marker. The backward gathers again, and
    the gradients arrive as the blocks' ``.grad``; without the saving
    hooks the forward's buffers would live until the backward."""
    import gc
    import weakref

    from uniter_tpu_torch.parallel import fsdp
    from uniter_tpu_torch.train_vqa import vqa_loss
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training.step import step_generator

    model = port_model(init_path[0], dtype=dtype, **DROP)
    opt = popt.build_optimizer(model, 1e-3, fused=True, fsdp=True,
                               fsdp_min_size=64)
    bases = []
    real = fsdp._Unit.gather_fulls

    def spy(self):
        fulls = real(self)
        bases.extend(weakref.ref(f) for f in fulls)
        return fulls

    casts = []
    real_pack = fsdp._pack

    def pack(t):
        out = real_pack(t)
        if isinstance(out, fsdp._Marker) and out.dtype is not None:
            casts.append(out.dtype)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(fsdp._Unit, "gather_fulls", spy)
    mp.setattr(fsdp, "_pack", pack)
    try:
        model.train()
        with fsdp.saving(model):
            loss = vqa_loss(model, _tt(BATCHES[0]), step_generator(0, 0),
                            N_ANS)
        gc.collect()
        n_forward = len(bases)
        assert n_forward > 0
        assert [r for r in bases if r() is not None] == []
        loss.backward()
    finally:
        mp.undo()
    assert len(bases) > n_forward  # gathered again for the backward
    # bf16 compute saves the weights' bf16 casts: markers, not copies
    assert bool(casts) == (dtype == "bfloat16")
    blocks = [g["shard"].block for g in opt.groups if g["sharded"]]
    assert blocks and all(b.grad is not None for b in blocks)


def test_validation_under_fsdp_matches_replicated(two_ranks):
    """The --fsdp model's predictions on evaluation batches that the ranks
    split unevenly (``local_params``: one gather for the whole pass) and
    on one batch through the per-unit gathers equal the replicated model's
    (1e-5): both trained 3 steps at dropout 0.1 at world 2."""
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch import config as pconfig

    _, _, params, _ = two_ranks[0]["drop_replicated"]
    model = UniterForVisualQuestionAnswering(
        pconfig.tiny_config(**DROP), img_dim=IMG_DIM, num_answer=N_ANS)
    model.load_state_dict(params)
    model.eval()
    with torch.no_grad():
        want = {i: model(_tt(b), False) for i, b in enumerate(BATCHES)}
    seen = set()
    for rank in range(2):
        got = two_ranks[rank]["valid"]
        for key, v in got.items():
            i = 0 if key == "lockstep" else key
            seen.add(key)
            np.testing.assert_allclose(v.numpy(), want[i].numpy(),
                                       atol=1e-5, err_msg=f"{rank} {key}")
    assert seen == {0, 1, 2, "lockstep"}


def test_pretrain_mix_under_fsdp_matches_one_process(tmp_path):
    """MLM, ITM with OT, MRFR and MRC-kl steps at 2 ranks with --fsdp
    (every head its own unit: in each step the other heads run nothing
    and their blocks take a zero gradient), dropout 0.1: every step's loss
    is one process's (1e-6 relative), and the parameters are the
    replicated ranks' (1e-6 of their largest). (Against one process the
    parameters move apart by up to ~2e-4 at lr 1e-3: MRC-kl's trunk
    gradients are ~1e-6, Adam's eps, where a sum in another order changes
    the first update's size.)"""
    run_job("pretrain", 2, tmp_path)
    want_l, _ = pretrain_run()
    for rank in range(2):
        runs = torch.load(tmp_path / f"pre{rank}.pt", weights_only=False)
        (rep_l, rep_p), (losses, params) = runs[False], runs[True]
        scale = max(float(v.abs().max()) for v in rep_p.values())
        np.testing.assert_allclose(losses, want_l, rtol=1e-6)
        np.testing.assert_allclose(rep_l, want_l, rtol=1e-6)
        _close(params, rep_p, 1e-6 * scale, f"pretrain rank {rank}")


def test_re_negatives_at_world_two_are_world_ones_block():
    """``sample_neg`` on rank p's rows of a global batch (its block of
    blocks) draws the negatives one process draws for those rows, from
    the same step generator."""
    from uniter_tpu_torch.models.re import sample_neg, sampling_generator
    from uniter_tpu_torch.training.step import step_generator

    rng = np.random.RandomState(0)
    b, n = 6, 9
    scores = torch.from_numpy(rng.randn(2 * b, n).astype(np.float32))
    targets = torch.from_numpy(rng.randint(0, n, 2 * b))
    masks = torch.from_numpy(rng.rand(2 * b, n) < 0.3)
    masks[torch.arange(2 * b), targets] = False

    def gen():
        return sampling_generator(step_generator(3, 1), "cpu")

    whole = sample_neg(scores, targets, masks, 0.5, gen())
    for p in range(2):
        rows = slice(p * b, (p + 1) * b)
        mine = sample_neg(scores[rows], targets[rows], masks[rows], 0.5,
                          gen(), p, 2)
        assert torch.equal(mine, whole[rows]), p
    assert not torch.equal(
        sample_neg(scores[b:], targets[b:], masks[b:], 0.5, gen()), whole[b:])


def test_sigterm_to_one_rank_stops_both_at_one_step(tmp_path, init_path):
    """Rank 1 gets SIGTERM in step 3; the agreement every 2 polls stops
    both after step 4, and rank 0's save of step 4 restores at world 1."""
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training.step import TrainState
    from uniter_tpu_torch.utils.save import TrainStateSaver

    run_job("sigterm", 2, tmp_path, init_path[0])
    stops = [json.load(open(tmp_path / f"stop{r}.json")) for r in range(2)]
    assert stops == [{"step": 4, "preempted": True}] * 2
    model = port_model(init_path[0])
    state = TrainState(step=0, model=model,
                       opt=popt.build_optimizer(model, 1e-3, fused=True))
    assert TrainStateSaver(str(tmp_path)).restore(state) is not None
    assert state.step == 4 and state.opt.count == 4


# ------------------------------------------------------------ the CLIs

N_CLI_ANS = 7
CLI_MODEL = dict(vocab_size=300, hidden_size=48, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=96,
                 max_position_embeddings=64, type_vocab_size=2,
                 hidden_act="gelu", initializer_range=0.02)


def vqa_dbs(root):
    """Six images, 24 questions (image i % 6 answers i % 6), written with
    the port's writers."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.txt_db import write_txt_db

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
    recs = {f"q_{i}": dict(
        input_ids=[int(x) for x in rng.randint(110, 300,
                                               rng.randint(4, 10))],
        img_fname=names[i % 6], target={"labels": [i % 6], "scores": [1.0]})
        for i in range(24)}
    write_txt_db(str(root / "txt"), recs, meta,
                 {k: r["img_fname"] for k, r in recs.items()})
    with open(root / "model.json", "w") as f:
        json.dump(CLI_MODEL, f)


def train_config(root, out):
    cfg = dict(train_txt_db=str(root / "txt"), train_img_db=str(root / "img"),
               val_txt_db=str(root / "txt"), val_img_db=str(root / "img"),
               model_config=str(root / "model.json"), output_dir=str(out),
               num_answer=N_CLI_ANS, train_batch_size=256,
               val_batch_size=512, max_bb=10, min_bb=3, num_bb=36,
               n_workers=0, warmup_steps=2, valid_steps=2, log_steps=1,
               num_train_steps=3, device="cpu", dropout=0.1, grad_norm=1e-3,
               dtype="float32")
    path = str(out) + ".json"
    with open(path, "w") as f:
        json.dump(cfg, f)
    return ["--config", path]


def _cli(module, args, world, *extra):
    return launch(["-m", f"uniter_tpu_torch.{module}", *args, *extra],
                  world)


def run_cli(module, args, world=2):
    """``module`` at ``world`` processes over gloo (torchrun's variables);
    every rank's output. The other files' CLI tests use it too."""
    return wait(_cli(module, args, world))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``train_vqa`` in fp32 at dropout 0.1, 3 steps then resumed to 5 (the
    schedule decays over 3 steps, then over 5): at world 1 both times; at
    world 2 with --fsdp, then at world 1; at world 1, then at world 2 with
    --fsdp; ``inf_vqa`` of the first run's step 3 at worlds 1 and 2 (the
    run is resumed to 5 in the same wave, so the step is named).
    ``loss_scale="sum"`` (the reference's sum of
    the ranks' mean gradients) makes world 2's gradient twice world 1's;
    the clip at ``grad_norm`` 1e-3, below every step's norm, takes both to
    the same update, and every rank applies its block of the one process's
    masks, so the runs agree to the order of the sums."""
    root = db_root = tmp_path_factory.mktemp("parallel_cli")
    vqa_dbs(db_root)
    runs = {name: train_config(root, root / name)
            for name in ("one_then_one", "two_then_one", "one_then_two")}
    fsdp = ["--fsdp", "--fsdp_min_size", "64"]
    wave = [_cli("train_vqa", runs["one_then_one"], 1),
            _cli("train_vqa", runs["two_then_one"], 2, *fsdp),
            _cli("train_vqa", runs["one_then_two"], 1)]
    logs = {"first": [wait(p) for p in wave]}
    five = ["--num_train_steps", "5"]
    wave = [_cli("train_vqa", runs["one_then_one"], 1, *five),
            _cli("train_vqa", runs["two_then_one"], 1, *five),
            _cli("train_vqa", runs["one_then_two"], 2, *fsdp, *five)]
    wave += [_cli("inf_vqa", ["--txt_db", str(db_root / "txt"), "--img_db",
                              str(db_root / "img"), "--train_dir",
                              str(root / "one_then_one"), "--ckpt", "3",
                              "--output_dir", str(root / f"ans{w}"),
                              "--device", "cpu", "--save_logits"], w)
             for w in (1, 2)]
    logs["second"] = [wait(p) for p in wave]
    return root, logs


@pytest.mark.parametrize("name", ["two_then_one", "one_then_two"])
def test_resume_across_topologies(cli_runs, name):
    root, logs = cli_runs

    def weights(run):
        return torch.load(root / run / "ckpt" / "model_step_5.pt",
                          weights_only=True)

    assert sum("resumed from step 3" in out
               for outs in logs["second"] for out in outs) == 3
    _close(weights(name), weights("one_then_one"), 1e-5, name)
    scalars = [json.loads(x) for x in open(root / name / "log" /
                                           "scalars.jsonl")]
    assert sum("valid/score" in s for s in scalars) == 2  # steps 2 and 4


def test_inf_vqa_world_two_writes_world_one_files(cli_runs):
    root, _ = cli_runs
    one = json.load(open(root / "ans1" / "results.json"))
    two = json.load(open(root / "ans2" / "results.json"))
    assert len(one) == 24 and two == one
    l1, l2 = np.load(root / "ans1" / "logits.npz"), np.load(
        root / "ans2" / "logits.npz")
    assert l1.files == l2.files
    for k in l1.files:
        np.testing.assert_allclose(l2[k].astype(np.float32),
                                   l1[k].astype(np.float32), atol=1e-3)


@pytest.fixture(scope="module")
def itm_dbs(tmp_path_factory):
    """13 captions over 6 images (a text count 2 ranks do not divide)."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.txt_db import write_txt_db

    root = tmp_path_factory.mktemp("parallel_itm")
    rng = np.random.RandomState(0)
    names = [f"flickr_{i:04d}.npz" for i in range(6)]
    imgs = {n: dict(features=rng.randn(nbb, 2048).astype(np.float16),
                    norm_bb=rng.rand(nbb, 6).astype(np.float16),
                    conf=np.linspace(1, 0.3, nbb).astype(np.float16),
                    soft_labels=rng.rand(nbb, 1601).astype(np.float16))
            for n, nbb in zip(names, rng.randint(4, 10, len(names)))}
    write_img_db(str(root / "img"), imgs, conf_th=0.2, max_bb=10, min_bb=3)
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [104, 300]}
    recs = {f"cap_{i}": dict(input_ids=[int(x) for x in rng.randint(
        110, 300, rng.randint(4, 12))], img_fname=names[i % 6])
        for i in range(13)}
    write_txt_db(str(root / "txt"), recs, meta,
                 {k: r["img_fname"] for k, r in recs.items()})
    return root


def test_retrieval_scoring_world_two_equals_world_one(tmp_path, itm_dbs):
    run_job("scoring", 2, tmp_path, itm_dbs)
    want = scoring(str(itm_dbs))
    for rank in range(2):
        got = np.load(tmp_path / f"scores{rank}.npz")
        for key, w in zip(("fast", "batched", "win"), want):
            assert got[key].shape == w.shape, key
            np.testing.assert_allclose(got[key], w, atol=1e-6, rtol=0,
                                       err_msg=key)


if __name__ == "__main__":
    from uniter_tpu_torch.parallel.collectives import init_distributed

    init_distributed("cpu")
    JOBS[sys.argv[1]](*sys.argv[2:])
