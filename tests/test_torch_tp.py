"""The port's tensor-parallel ``model`` axis (``uniter_tpu_torch/parallel``
``mesh.make_mesh``, ``tp.py``) on the CPU: a data x model grid of gloo
processes started with torchrun's variables (``test_torch_parallel.py``'s
launcher), 2 torch threads each, ``tiny_config`` widths (64 hidden, 4
heads, 128 FFN).

* The grid: rank r at (r // model, r % model), the model groups
  consecutive, the data groups strided, at 1x2, 2x2 and 4x2.
* The placement: a rank's block of every column- or row-parallel weight is
  its ``_tp_spec`` slice of the full tensor; ``shard_state`` /
  ``gather_state`` round-trip bit for bit; a grid whose model axis does
  not divide the hidden size, the heads or the FFN width is refused with
  the reason; at 1x2 ``param_bytes`` drops by half the sharded matrices.
* Against JAX at dropout 0: the 2x2 grid's 3 steps equal the JAX
  package's ``make_train_step`` on a 2x2 mesh with ``param_sharding_full``
  (FSDP off and on): losses 1e-5 relative, parameters 1e-5. The forward
  of ``tests/test_parallel.py``'s 4x2 shape on 8 ranks equals JAX's
  one-device forward within that test's 2e-5.
* Against one process at dropout 0.1: the 1x2 and 2x2 grids, replicated,
  ``--fsdp`` and ``--fsdp --remat``: losses 1e-6 relative at every step,
  parameters 1e-6 of their largest, gradient norms 1e-6 relative (times
  the data size, the ``"sum"`` scale). The JAX package's own dp x tp
  meshes have the property (its test here, 1e-5).
* A 2x2 ``--fsdp`` save resumed at world 1, and a world-1 save resumed on
  2x2 ``--fsdp``, equal the one process's third step (1e-5).
* ``dryrun_multichip(4)`` runs to its end on four ranks.

The workers are this file run as a script (``python tests/test_torch_tp.py
JOB OUT ...``); they import neither jax nor the JAX package.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import (  # noqa: F401 (init_path: a fixture)
    BATCHES, DROP, IMG_DIM, N_ANS, NO_DROP, SCHED, _close, _tt, block,
    init_path, launch, port_model, train_run, wait)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
HERE = os.path.abspath(__file__)
torch.set_num_threads(2)

GRID_MODES = {  # name -> (model config, optimizer options)
    "replicated": ({}, {}),
    "fsdp": ({}, dict(fsdp=True, fsdp_min_size=64)),
    "fsdp_remat": (dict(remat=True), dict(fsdp=True, fsdp_min_size=64)),
}
FWD_B, FWD_T, FWD_R = 16, 8, 8  # tests/test_parallel.py's 4x2 forward


def fwd_batch():
    rng = np.random.RandomState(0)
    return dict(
        input_ids=rng.randint(1, 500, (FWD_B, FWD_T)).astype(np.int32),
        position_ids=np.tile(np.arange(FWD_T, dtype=np.int32), (FWD_B, 1)),
        img_feat=rng.randn(FWD_B, FWD_R, IMG_DIM).astype(np.float32),
        img_pos_feat=rng.rand(FWD_B, FWD_R, 7).astype(np.float32),
        attn_mask=np.ones((FWD_B, FWD_T + FWD_R), np.int32),
        ex_weight=np.ones(FWD_B, np.float32))


def grid_run(init_path, batches, cfg=None, save=None, resume=None,
             **opt_kw):
    """(losses, grad norms, final full parameters, what the rank holds)
    of ``batches`` on this rank's data blocks through ``place_state`` on
    the running grid; ``save`` a directory to save the state to after the
    run, ``resume`` one to restore from before it."""
    from uniter_tpu_torch.parallel.collectives import data_index, data_size
    from uniter_tpu_torch.train_vqa import vqa_loss
    from uniter_tpu_torch.training import sched as psched
    from uniter_tpu_torch.training import step as pstep
    from uniter_tpu_torch.training.driver import place_state
    from uniter_tpu_torch.utils.save import TrainStateSaver

    model = port_model(init_path, **(cfg or {}))
    state = place_state(model, psched.get_lr_schedule(*SCHED), grad_norm=1.0,
                        lr_mul=10.0, lr_mul_paths=("vqa_",), fused=True,
                        **opt_kw)
    if resume:
        assert TrainStateSaver(resume).restore(state) is not None
    step = pstep.make_train_step(
        lambda m, b, g: (vqa_loss(m, b, g, N_ANS), {}), loss_scale="sum")
    losses, norms = [], []
    for batch in batches:
        state, m = step(state, _tt(block(batch, data_index(), data_size())),
                        0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    if save:
        TrainStateSaver(save).save(state.step, state)
    held = {"param_bytes": state.opt.param_bytes(),
            "state_bytes": state.opt.state_bytes()}
    params = {k: v.detach().float().clone()
              for k, v in model.state_dict().items()}
    return losses, norms, params, held


def spec_slice(full, spec, index):
    """``full``'s block at model index ``index`` of its spec (numpy)."""
    axis = spec.index("model")
    n = 2
    w = full.shape[axis] // n
    return np.take(full, np.arange(index * w, (index + 1) * w), axis=axis)


def placement_checks(init_path):
    """This rank's TP blocks against the ``_tp_spec`` slices of the full
    tensors, and the ``shard_state`` / ``gather_state`` round trip."""
    from uniter_tpu_torch.parallel.collectives import model_index
    from uniter_tpu_torch.parallel.mesh import (
        MeshConfig, current_mesh, param_sharding_full)
    from uniter_tpu_torch.parallel.tp import (
        gather_state, shard_model, shard_state)

    full = torch.load(init_path, weights_only=True)
    model = port_model(init_path)
    layout = shard_model(model)
    specs = param_sharding_full([(k, v.shape) for k, v in full.items()],
                                current_mesh(), MeshConfig())
    params = dict(model.named_parameters())
    sliced = {k: bool(np.array_equal(
        params[k].detach().numpy(),
        spec_slice(full[k].numpy(), specs[k], model_index())))
        for k, s in specs.items() if "model" in s}
    blocks = shard_state(full, layout)
    same_blocks = all(torch.equal(blocks[k], params[k].detach())
                      for k in params)
    back = gather_state(blocks, layout)
    round_trip = all(torch.equal(back[k], full[k]) for k in full)
    gathered = model.state_dict()
    state_dict = all(torch.equal(gathered[k], full[k]) for k in full)
    return {"sliced": sliced, "blocks": same_blocks,
            "round_trip": round_trip, "state_dict": state_dict,
            "n_tp": len(layout.axes), "cls": cls_row(model)}


def cls_row(model):
    """The last layer's CLS row through ``BertLayerCLS`` on this rank's
    blocks (``parallel.tp.follow``, as the retrieval scorer builds it), on
    a seeded input."""
    from uniter_tpu_torch.models.encoder import BertLayerCLS, attn_bias
    from uniter_tpu_torch.parallel.tp import follow

    last = model.uniter.encoder.layer[-1]
    cls = follow(BertLayerCLS(last.cfg), last)
    cls.load_state_dict(last.state_dict(), strict=True)
    g = torch.Generator().manual_seed(5)
    hidden = torch.randn(3, 7, last.cfg.hidden_size, generator=g)
    mask = torch.ones(3, 7)
    mask[1, 5:] = 0
    with torch.no_grad():
        return cls.eval()(hidden, attn_bias(mask))


def grid_record():
    """This rank's coordinates and the members of its two groups."""
    from uniter_tpu_torch.parallel import collectives as C

    return {"rank": C.process_index(), "d": C.data_index(),
            "m": C.model_index(), "data": C.data_size(),
            "model": C.model_size(),
            "data_group": C.all_gather_list(C.process_index(),
                                            C.data_group()),
            "model_group": C.all_gather_list(C.process_index(),
                                             C.model_group())}


def rebuild_record(model_axis):
    """``make_mesh`` again on a built grid: the same grid keeps its groups,
    another grid (the world along ``data``) is refused."""
    from uniter_tpu_torch.parallel import collectives as C
    from uniter_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    groups = (C.data_group(), C.model_group())
    same = make_mesh(MeshConfig(model=model_axis)).shape
    kept = groups == (C.data_group(), C.model_group())
    try:
        make_mesh(MeshConfig(model=1))
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"same": same, "kept": kept, "refused": refused,
            "after": C.model_size()}


# ------------------------------------------------------------ the workers

def job_grid(out, init_path, model_axis, ckpt_in):
    """Every run of the grid ``(world / model_axis) x model_axis``."""
    from uniter_tpu_torch.parallel.collectives import process_index
    from uniter_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    make_mesh(MeshConfig(model=int(model_axis)))
    rank = process_index()
    res = {"grid": grid_record(), "again": rebuild_record(int(model_axis)),
           "placement": placement_checks(init_path)}
    for mode, (cfg, kw) in GRID_MODES.items():
        res[f"drop_{mode}"] = grid_run(init_path, BATCHES, {**DROP, **cfg},
                                       **kw)
    if res["grid"]["data"] == 2:
        for mode in ("replicated", "fsdp"):
            res[mode] = grid_run(init_path, BATCHES, **GRID_MODES[mode][1])
        res["saved"] = grid_run(init_path, BATCHES[:2], DROP,
                                save=os.path.join(out, "ckpt_grid"),
                                **GRID_MODES["fsdp"][1])
        res["resumed"] = grid_run(init_path, BATCHES[2:], DROP,
                                  resume=ckpt_in, **GRID_MODES["fsdp"][1])
    torch.save(res, os.path.join(out, f"grid{rank}.pt"))


def job_forward(out, init_path):
    """The 4x2 forward of ``fwd_batch`` in eval mode: each data rank's
    block, gathered over the data axis, written by rank 0."""
    from uniter_tpu_torch.parallel.collectives import (
        all_gather_array, data_group, data_index, data_size, process_index)
    from uniter_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from uniter_tpu_torch.parallel.tp import shard_model

    make_mesh(MeshConfig(data=4, model=2))
    model = port_model(init_path).eval()
    shard_model(model)
    with torch.no_grad():
        mine = model(_tt(block(fwd_batch(), data_index(), data_size())),
                     False).float().numpy()
    rows = all_gather_array(mine, data_group()).reshape(FWD_B, -1)
    rec = grid_record()
    if process_index() == 0:
        np.save(os.path.join(out, "forward.npy"), rows)
    with open(os.path.join(out, f"fwd{process_index()}.json"), "w") as f:
        json.dump(rec, f)


# ------------------------------------------------------------ fixtures

def _run(job, world, out, *args):
    return wait(launch([HERE, job, str(out), *map(str, args)], world))


@pytest.fixture(scope="module")
def one_process(init_path):
    """The one-process runs the grids are held to, and a world-1 save
    after two steps (resumed on the 2x2 grid)."""
    path = init_path[0]
    out = {f"drop_{mode}": train_run(path, BATCHES, cfg={**DROP, **cfg})
           for mode, (cfg, _) in GRID_MODES.items() if mode != "fsdp"}
    out["replicated"] = train_run(path, BATCHES)
    return out


@pytest.fixture(scope="module")
def world_one_ckpt(init_path, tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_ckpt1")
    grid_run(init_path[0], BATCHES[:2], DROP, save=str(root))
    return root


@pytest.fixture(scope="module")
def grids(init_path, world_one_ckpt, tmp_path_factory):
    """{"1x2": ranks' records, "2x2": ranks' records, "dir": 2x2's}."""
    out = {}
    for name, world in (("1x2", 2), ("2x2", 4)):
        d = tmp_path_factory.mktemp(f"tp_{name}")
        _run("grid", world, d, init_path[0], 2, world_one_ckpt)
        out[name] = [torch.load(d / f"grid{r}.pt", weights_only=False)
                     for r in range(world)]
        out[f"dir_{name}"] = d
    return out


@pytest.fixture(scope="module")
def forward8(init_path, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_fwd")
    _run("forward", 8, d, init_path[0])
    return (np.load(d / "forward.npy"),
            [json.load(open(d / f"fwd{r}.json")) for r in range(8)])


# ------------------------------------------------------------ the grid

def _want_grid(data, model):
    return [{"rank": r, "d": r // model, "m": r % model, "data": data,
             "model": model,
             "data_group": [d * model + r % model for d in range(data)],
             "model_group": [r // model * model + m for m in range(model)]}
            for r in range(data * model)]


@pytest.mark.parametrize("shape", ["1x2", "2x2", "4x2"])
def test_grid_layout_and_groups(grids, forward8, shape):
    data, model = map(int, shape.split("x"))
    got = (forward8[1] if shape == "4x2"
           else [r["grid"] for r in grids[shape]])
    assert got == _want_grid(data, model)


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_make_mesh_builds_the_grid_once(grids, shape):
    """``make_mesh`` of the same grid keeps the groups every placement
    holds; another grid is refused and leaves the first in place."""
    data, model = map(int, shape.split("x"))
    for rec in grids[shape]:
        again = rec["again"]
        assert again["same"] == {"data": data, "model": model}
        assert again["kept"] and again["after"] == model
        assert f"a {data}x{model} grid is built already" in again["refused"]


def test_make_mesh_in_one_process():
    from uniter_tpu_torch.parallel import collectives as C
    from uniter_tpu_torch.parallel.mesh import (
        MeshConfig, current_mesh, make_mesh)

    assert make_mesh().shape == {"data": 1, "model": 1}
    assert current_mesh().shape == {"data": 1, "model": 1}
    assert (C.data_size(), C.data_index(), C.model_size(),
            C.model_index()) == (1, 0, 1, 0)
    assert C.data_group() is None and C.model_group() is None
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(MeshConfig(model=2))


# ------------------------------------------------------------ placement

@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_blocks_are_tp_spec_slices(grids, shape):
    """Every column- and row-parallel tensor (10 a layer, 2 layers) of
    every rank is its ``_tp_spec`` slice of the full tensor."""
    for rec in grids[shape]:
        placed = rec["placement"]
        assert placed["n_tp"] == 20
        assert len(placed["sliced"]) == 20 and all(
            placed["sliced"].values()), placed["sliced"]
        names = set(placed["sliced"])
        assert any(n.endswith("attention.self.query.weight") for n in names)
        assert any(n.endswith("attention.output.dense.weight")
                   for n in names)
        assert not any(n.endswith("output.dense.bias") for n in names)


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_cls_layer_on_tp_blocks_matches_one_process(grids, init_path,
                                                    shape):
    """The retrieval scorer's ``BertLayerCLS`` built on a rank's blocks
    (``follow``) gives the one process's CLS row (1e-6)."""
    want = cls_row(port_model(init_path[0]))
    for rec in grids[shape]:
        torch.testing.assert_close(rec["placement"]["cls"], want, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_shard_state_gather_state_round_trip(grids, shape):
    for rec in grids[shape]:
        placed = rec["placement"]
        assert placed["blocks"] and placed["round_trip"]
        assert placed["state_dict"]  # model.state_dict() gathers


@pytest.mark.parametrize("what,cfg,n", [
    ("hidden size", {}, 3),
    ("attention heads", {}, 8),
    ("intermediate size", dict(intermediate_size=66), 4)])
def test_placement_refuses_an_indivisible_grid(init_path, what, cfg, n):
    from uniter_tpu_torch import config as pconfig
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch.parallel.tp import _check_divides

    model = UniterForVisualQuestionAnswering(
        pconfig.tiny_config(**cfg), img_dim=IMG_DIM, num_answer=N_ANS)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=f"does not divide .*{what}"):
        _check_divides(model, n)
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_param_bytes_on_1x2(grids, one_process):
    """At 1x2 a rank holds half of each TP-sharded tensor and all of the
    rest: the replicated bytes less half the sharded ones, exactly."""
    _, _, full, _ = one_process["replicated"]
    total = sum(v.numel() * 4 for v in full.values())
    names = set(grids["1x2"][0]["placement"]["sliced"])
    split = sum(full[k].numel() * 4 for k in names)
    for rec in grids["1x2"]:
        held = rec["drop_replicated"][3]["param_bytes"]
        assert held == total - split // 2, (held, total, split)
        assert 0.5 * total < held < total


# ------------------------------------------------------------ vs one process

@pytest.mark.parametrize("mode", list(GRID_MODES))
@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_grid_at_dropout_matches_one_process(grids, one_process, shape,
                                             mode):
    """Dropout 0.1: each rank's masks are its data block and head block
    of the one process's, so every step's loss is the one process's
    (1e-6 relative) and so are the parameters after the last step (1e-6
    of their largest), ``--fsdp --remat`` against the one process with
    remat (remat replays the masks)."""
    ref = "drop_fsdp_remat" if mode == "fsdp_remat" else "drop_replicated"
    want_l, _, want_p, _ = one_process[ref]
    scale = max(float(v.abs().max()) for v in want_p.values())
    for rank, rec in enumerate(grids[shape]):
        losses, _, params, _ = rec[f"drop_{mode}"]
        np.testing.assert_allclose(losses, want_l, rtol=1e-6)
        _close(params, want_p, 1e-6 * scale, f"{shape} {mode} rank {rank}")


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_grad_norm_under_tp_matches_one_process(grids, one_process, shape):
    """The pre-clip norm counts each TP block once over the model group
    and each replicated gradient once: the one process's norm times the
    data size (``loss_scale="sum"``)."""
    want = np.asarray(one_process["drop_replicated"][1])
    dp = int(shape.split("x")[0])
    for rec in grids[shape]:
        for mode in GRID_MODES:
            if mode == "fsdp_remat":
                continue
            np.testing.assert_allclose(rec[f"drop_{mode}"][1], dp * want,
                                       rtol=1e-6)


# ------------------------------------------------------------ vs JAX

def jax_grid_run(params, batches, data, model, fsdp, drop):
    """(losses, final params) of the JAX package's ``make_train_step`` on
    a data x model mesh with ``param_sharding_full`` (and FSDP at 64
    elements), the placement of its dry run."""
    import jax
    import jax.numpy as jnp
    from uniter_tpu.config import tiny_config as jax_tiny
    from uniter_tpu.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu.parallel.mesh import (
        MeshConfig, batch_sharding, make_mesh, opt_state_sharding,
        param_sharding_full, replicate)
    from uniter_tpu.training import optim as jopt
    from uniter_tpu.training import sched as jsched
    from uniter_tpu.training.step import TrainState, make_train_step

    jmodel = UniterForVisualQuestionAnswering(
        jax_tiny(**(DROP if drop else NO_DROP)), img_dim=IMG_DIM,
        num_answer=N_ANS)

    def loss(p, batch, rng):
        per = jmodel.apply({"params": p}, batch, True, deterministic=False,
                           rngs={"dropout": rng})
        w = batch["ex_weight"][:, None]
        return (jnp.sum(per * w)
                / jnp.maximum(jnp.sum(w) * N_ANS, 1.0)) * N_ANS, {}

    mcfg = MeshConfig(data=data, model=model, fsdp=fsdp, fsdp_min_size=64)
    mesh = make_mesh(mcfg, devices=jax.devices()[:data * model])
    params = jax.tree.map(jnp.asarray, params)
    tx = jopt.build_optimizer(params, jsched.get_lr_schedule(*SCHED),
                              grad_norm=1.0, lr_mul=10.0,
                              lr_mul_paths=("vqa_",), fused=True)
    state = TrainState.create(params, tx)
    psh = param_sharding_full(params, mesh, mcfg)
    state = state.replace(
        params=jax.device_put(state.params, psh),
        opt_state=jax.device_put(state.opt_state, opt_state_sharding(
            state.opt_state, tx, psh, mesh)),
        step=jax.device_put(state.step, replicate(mesh)))
    step = make_train_step(loss, mesh=mesh, loss_scale="sum", donate=False)
    bsh = batch_sharding(mesh)
    losses = []
    for batch in batches:
        state, m = step(state, jax.device_put(
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.tree.map(lambda _: bsh, batch)), jax.random.PRNGKey(3))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_2x2_grid_matches_jax_2x2_mesh(grids, init_path, mode):
    """Dropout 0: the port's 2x2 grid (four gloo ranks) against the JAX
    package's 2x2 mesh step with ``param_sharding_full``, FSDP off and
    on: losses 1e-5 relative, parameters 1e-5."""
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params

    losses, params = jax_grid_run(init_path[1], BATCHES, 2, 2,
                                  mode == "fsdp", drop=False)
    want = {k: torch.tensor(np.asarray(v)) for k, v in
            state_dict_from_jax_params(params).items()}
    for rank, rec in enumerate(grids["2x2"]):
        got_l, _, got_p, _ = rec[mode]
        np.testing.assert_allclose(got_l, losses, rtol=1e-5)
        _close(got_p, want, 1e-5, f"{mode} rank {rank} vs jax")


def test_jax_dp_tp_meshes_at_dropout_match_one_device(init_path):
    """The reference's property the port is held to: at dropout 0.1 the
    JAX package's step on 2x2 (FSDP off and on) and 1x4 meshes with
    ``param_sharding_full`` equals its one-device step (losses 1e-5
    relative, parameters 1e-5): its masks over the global arrays do not
    depend on how a model axis splits the heads."""
    import jax

    want_l, want_p = jax_grid_run(init_path[1], BATCHES, 1, 1, False, True)
    for data, model, fsdp in ((2, 2, False), (2, 2, True), (1, 4, False)):
        got_l, got_p = jax_grid_run(init_path[1], BATCHES, data, model,
                                    fsdp, True)
        np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
        for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(want_p)):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_4x2_forward_matches_jax(forward8, init_path):
    """``tests/test_parallel.py``'s 4x2 forward shape (B 16, T 8, R 8) on
    8 gloo ranks against the JAX forward on one device (2e-5)."""
    import jax
    import jax.numpy as jnp
    from uniter_tpu.config import tiny_config as jax_tiny
    from uniter_tpu.models.vqa import UniterForVisualQuestionAnswering

    jmodel = UniterForVisualQuestionAnswering(
        jax_tiny(**NO_DROP), img_dim=IMG_DIM, num_answer=N_ANS)
    params = jax.tree.map(jnp.asarray, init_path[1])
    ref = jmodel.apply({"params": params},
                       {k: jnp.asarray(v) for k, v in fwd_batch().items()},
                       False)
    np.testing.assert_allclose(forward8[0], np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


# ------------------------------------------------------------ resume

def test_2x2_fsdp_save_resumed_at_world_one(grids, init_path, one_process):
    """A 2x2 ``--fsdp`` run saved after two steps, resumed in one process
    for the third: the one process's third step (1e-5)."""
    want_l, _, want_p, _ = one_process["drop_replicated"]
    losses, _, params, _ = grid_run(
        init_path[0], BATCHES[2:], DROP,
        resume=str(grids["dir_2x2"] / "ckpt_grid"))
    np.testing.assert_allclose(losses, want_l[2:], rtol=1e-5)
    scale = max(float(v.abs().max()) for v in want_p.values())
    _close(params, want_p, 1e-5 * scale, "2x2 -> 1")


def test_world_one_save_resumed_on_2x2_fsdp(grids, one_process):
    """A world-1 save after two steps, resumed on the 2x2 ``--fsdp``
    grid for the third: the one process's third step (1e-5)."""
    want_l, _, want_p, _ = one_process["drop_replicated"]
    scale = max(float(v.abs().max()) for v in want_p.values())
    for rank, rec in enumerate(grids["2x2"]):
        losses, _, params, _ = rec["resumed"]
        np.testing.assert_allclose(losses, want_l[2:], rtol=1e-5)
        _close(params, want_p, 1e-5 * scale, f"1 -> 2x2 rank {rank}")


# ------------------------------------------------------------ the dry run

def test_dryrun_multichip_on_four_ranks():
    outs = wait(launch(["-m", "uniter_tpu_torch.dryrun", "--device", "cpu"],
                       4))
    assert "mesh {'data': 2, 'model': 2}" in outs[0], outs[0][-2000:]
    assert "scores (9, 6)" in outs[0]


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from uniter_tpu_torch.parallel.collectives import init_distributed

    init_distributed("cpu")
    globals()[f"job_{sys.argv[1]}"](*sys.argv[2:])
