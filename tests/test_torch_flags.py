"""The single-card training flags of the port against the JAX package, on
the CPU.

* ``--dropout_impl u16|u8`` (``ops/dropout.py``): the JAX thresholds and
  fallbacks; the keep fraction within 4 sigma of the quantized keep rate,
  kept values exactly ``x / keep_q``, the same mask from the same seed;
  the encoder trains with it (the run of tests/test_encoder.py
  ``test_dropout_impl_u16_trains``).
* ``--optim adam|adamax``: three updates with clipping and the head
  multiplier within 1e-6 of ``uniter_tpu.training.optim.build_optimizer``.
* Master-weight mode (``--param_dtype bfloat16``): three updates against
  JAX master mode (masters to 1e-6, bf16 leaves within a bf16 step, small
  leaves fp32); the export holds the fp32 masters; a resume at dropout 0.1
  continues bit for bit.
* ``--remat``: JAX ``remat=True`` gradients at rate 0 (1e-5 of the
  gradient scale); at rate 0.1 the port with and without remat from the
  same step generator: the same loss and the same gradients bit for bit,
  and the same count of seeds drawn; a checkpoint that draws its seeds
  inside draws more and gets other gradients.
* ``--wire_codec int8``: payload and scale equal JAX
  ``_quantize_wire_int8``, dequantized within rounding of ``_dequant_q8``
  and within max|row| / 254 of the input.
* An asynchronous save survives an in-place update made right after it,
  and a failed write raises at the next wait.
* ``--fsdp`` parses beside every other flag and a master-mode step with
  sharded groups at world size 1 equals the step without it; every flag runs:
  the CLI chain ``prepro`` + ``convert_imgdir`` -> ``train_vqa --remat
  --param_dtype bfloat16 --fused_adamw 1 --wire_codec int8 --dropout_impl
  u16 --profile_dir`` 3 steps (a trace of exactly the profiled window),
  resume to 5 -> ``inf_vqa``, 2 steps with ``--optim adam``; and
  ``pretrain`` (``MixedTaskLoop``) with the same flags, then ``--optim
  adamax``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_pretrain import _opts as _pretrain_opts, dbs  # noqa: F401
from test_torch_train import (BATCHES, IMG_DIM, N_ANS, NO_DROP, _bridge,
                              _port_model, _tt, jax_params)  # noqa: F401
from uniter_tpu.config import tiny_config as jax_tiny
from uniter_tpu.models.encoder import UniterModel as JaxUniterModel
from uniter_tpu.models.vqa import UniterForVisualQuestionAnswering as JaxVqa
from uniter_tpu.training import optim as jopt
from uniter_tpu.training import sched as jsched
from uniter_tpu.training.step import TrainState as JaxState
from uniter_tpu_torch import config as pconfig
from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
from uniter_tpu_torch.models.encoder import UniterEncoder, UniterModel
from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
from uniter_tpu_torch.ops import dropout as D
from uniter_tpu_torch.train_vqa import vqa_loss
from uniter_tpu_torch.training import driver
from uniter_tpu_torch.training import optim as popt
from uniter_tpu_torch.training import sched as psched
from uniter_tpu_torch.training import step as pstep
from uniter_tpu_torch.training.loop import train_batch_to_device
from uniter_tpu_torch.utils.save import TrainStateSaver

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
torch.set_num_threads(2)


# ---------------------------------------------------------------- dropout

@pytest.mark.parametrize("impl,bits", [("u16", 16), ("u8", 8)])
def test_reduced_bit_dropout_rule(impl, bits):
    rate, shape = 0.1, (600, 700)
    n_bits, thr, keep_q = D.mask_rule(rate, impl)
    assert (n_bits, thr) == (bits, int(round(rate * 2**bits)))
    assert keep_q == 1.0 - thr / 2**bits
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    y = D.drop(x, rate, 77, impl)
    keep = D.keep_mask(77, 0, shape, rate, impl=impl)
    assert torch.equal(y != 0, keep)
    n = keep.numel()
    frac = keep.float().mean().item()
    sigma = (keep_q * (1 - keep_q) / n) ** 0.5
    assert abs(frac - keep_q) <= 4 * sigma, (frac, keep_q)
    assert torch.equal(y[keep], x[keep] * torch.tensor(1.0 / keep_q))
    assert torch.equal(D.drop(x, rate, 77, impl), y)
    assert not torch.equal(D.drop(x, rate, 78, impl), y)
    # the bits are the top ``bits`` of the 32-bit rule's Philox words
    words = D.random_bits(77, 0, shape)
    assert torch.equal(keep, (words >> (32 - bits)) >= thr)
    # E[y] = x: the quantized keep rate, not 1 - rate, scales the kept
    ones = torch.ones(shape)
    mean = D.drop(ones, rate, 5, impl).mean().item()
    assert abs(mean - 1.0) <= 4 * sigma / keep_q


def test_reduced_bit_dropout_falls_back_like_jax():
    """A rate whose threshold rounds to 0 or to the top takes the 32-bit
    rule, as the JAX function falls through to bernoulli."""
    for impl, rate in (("u16", 1e-6), ("u8", 1e-3), ("u8", 0.999)):
        assert D.mask_rule(rate, impl) == (32, D.threshold(rate), 1.0 - rate)
        x = torch.ones(64, 64)
        assert torch.equal(D.drop(x, rate, 3, impl), D.drop(x, rate, 3))
    assert D.mask_rule(0.1, "xla") == (32, D.threshold(0.1), 0.9)
    with pytest.raises(ValueError):
        D.mask_rule(0.1, "u4")


def _trunk_batch(b=4, t=8, r=4, img=16, seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        input_ids=rng.randint(1, 500, (b, t)).astype(np.int64),
        position_ids=np.broadcast_to(np.arange(t), (b, t)).copy(),
        img_feat=rng.randn(b, r, img).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=np.ones((b, t + r), np.int64))


def _trunk_args(batch):
    return [torch.from_numpy(batch[k]) for k in
            ("input_ids", "position_ids", "img_feat", "img_pos_feat",
             "attn_mask")]


@pytest.mark.parametrize("impl", ["u16", "u8"])
def test_dropout_impl_trains(impl):
    """tests/test_encoder.py test_dropout_impl_u16_trains in the port: the
    tails' masks follow ``impl``, the output is finite and differs from
    the deterministic one, and a step's gradients are finite."""
    torch.manual_seed(0)
    model = UniterModel(pconfig.tiny_config(dropout_impl=impl), img_dim=16)
    args = _trunk_args(_trunk_batch())
    det = model(*args, deterministic=True)
    calls = []
    real = D.drop

    def spy(x, rate, seed, impl="xla", row_base=0):
        calls.append(impl)
        return real(x, rate, seed, impl, row_base)

    mp = pytest.MonkeyPatch()
    from uniter_tpu_torch.models import encoder

    mp.setattr(encoder, "drop", spy)
    try:
        out = model(*args, deterministic=False,
                    generator=torch.Generator().manual_seed(3))
    finally:
        mp.undo()
    assert calls == [impl] * (2 + 2 * 2)  # embedding tails + 2 per layer
    assert torch.isfinite(out).all() and not torch.allclose(out, det)
    out.square().sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)


# ---------------------------------------------------------------- adam(ax)

@pytest.mark.parametrize("optim", ["adam", "adamax"])
@pytest.mark.parametrize("grad_norm,lr_mul", [(0.0, 1.0), (0.5, 10.0)])
def test_adam_and_adamax_match_jax(jax_params, optim, grad_norm,  # noqa: F811
                                   lr_mul):
    rng = np.random.RandomState(2)
    grads = [jax.tree.map(lambda p: (rng.randn(*np.shape(p)) * 0.1)
                          .astype(np.float32), jax_params) for _ in range(3)]
    sched_args = (1e-2, 2, 10)
    tx = jopt.build_optimizer(
        jax.tree.map(jnp.asarray, jax_params),
        jsched.get_lr_schedule(*sched_args), grad_norm=grad_norm,
        lr_mul=lr_mul, lr_mul_paths=("vqa_",), optim=optim, fused=True)
    jstate = JaxState.create(jax.tree.map(jnp.asarray, jax_params), tx)
    model = _port_model(jax_params, **NO_DROP)
    opt = popt.build_optimizer(
        model, psched.get_lr_schedule(*sched_args), grad_norm=grad_norm,
        lr_mul=lr_mul, lr_mul_paths=("vqa_",), optim=optim, fused=True,
        mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16)
    # the chain keeps fp32 moments and decays nothing, as optax's does
    assert all(g["mu"].dtype == g["nu"].dtype == torch.float32
               and not g["decay"] for g in opt.groups)
    params = dict(model.named_parameters())
    for g in grads:
        jstate = jstate.apply_gradients(jax.tree.map(jnp.asarray, g))
        for k, v in _bridge(g).items():
            params[k].grad = v.clone()
        opt.step()
        want = _bridge(jstate.params)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="invalid optimizer"):
        popt.build_optimizer(model, 1e-3, optim="sgd")


# ---------------------------------------------------------------- master

MASTER_IMG = 1024  # img_linear 1024 x 64 = 2**16 elements: stored bf16
MASTER_VOCAB = 1100  # word table 1100 x 64 > 2**16: stored bf16


def _master_cfg(**kw):
    return dict(vocab_size=MASTER_VOCAB, **kw)


def _master_batch(seed):
    rng = np.random.RandomState(seed)
    b, t, r = 4, 8, 5
    return dict(
        input_ids=rng.randint(1, MASTER_VOCAB, (b, t)).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        img_feat=rng.randn(b, r, MASTER_IMG).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=np.ones((b, t + r), np.int32),
        targets=(rng.rand(b, N_ANS) < 0.3).astype(np.float32),
        ex_weight=np.ones(b, np.float32))


def test_master_mode_matches_jax():
    batch = _master_batch(0)
    jmodel = JaxVqa(jax_tiny(**_master_cfg()), img_dim=MASTER_IMG,
                    num_answer=N_ANS)
    p32 = jax.tree.map(np.asarray, dict(jmodel.init(
        {"params": jax.random.PRNGKey(0)},
        {k: jnp.asarray(v) for k, v in batch.items()}, False)["params"]))
    tx = jopt.build_optimizer(
        jax.tree.map(jnp.asarray, p32), jsched.get_lr_schedule(1e-2, 2, 10),
        grad_norm=0.5, lr_mul=10.0, lr_mul_paths=("vqa_",), fused=True,
        master=True)
    jstate = JaxState.create(jax.tree.map(jnp.asarray, p32), tx)
    jstate = jstate.replace(params=_jax_cast_storage(jstate.params))
    low = {k for k, v in _bridge_raw(jstate.params).items()
           if v.dtype != np.float32}

    model = UniterForVisualQuestionAnswering(
        pconfig.tiny_config(**_master_cfg()), img_dim=MASTER_IMG,
        num_answer=N_ANS)
    model.load_state_dict(_bridge(p32), strict=True)
    opt = popt.build_optimizer(
        model, psched.get_lr_schedule(1e-2, 2, 10), grad_norm=0.5,
        lr_mul=10.0, lr_mul_paths=("vqa_",), fused=True, master=True)
    params = dict(model.named_parameters())
    assert low == set(opt.masters()) == {
        "uniter.embeddings.word_embeddings.weight",
        "uniter.img_embeddings.img_linear.weight"}
    for k, p in params.items():
        assert p.dtype == (torch.bfloat16 if k in low else torch.float32), k
    rng = np.random.RandomState(5)
    for _ in range(3):
        # bf16-stored leaves receive bf16 gradients, in both packages
        g = jax.tree.map(lambda p: (rng.randn(*np.shape(p)) * 0.1).astype(
            np.float32), p32)
        gt = _bridge(g)
        for k in low:
            gt[k] = gt[k].to(torch.bfloat16)
        g = jax.tree.map(lambda p, x: np.asarray(
            jnp.asarray(x).astype(p.dtype)), jstate.params, g)
        jstate = jstate.apply_gradients(jax.tree.map(jnp.asarray, g))
        for k, v in gt.items():
            params[k].grad = v.clone()
        opt.step()
        masters = _bridge(jstate.opt_state.master)
        stored = _bridge(jstate.params)
        mine = {**{k: p.detach() for k, p in params.items()},
                **opt.masters()}
        for k in params:
            np.testing.assert_allclose(mine[k].numpy(), masters[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            if k in low:
                a = params[k].detach().float().numpy()
                b = stored[k].numpy()
                # one bf16 step, on top of the masters' 1e-6 (a master
                # near 0 sits on a finer bf16 grid than 1e-6)
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                    np.abs(b), 1e-30))) - 7)
                assert (np.abs(a - b) <= ulp + 1e-6).all(), k
                # each stored leaf is its master rounded once
                assert torch.equal(params[k].detach(),
                                   opt.masters()[k].to(torch.bfloat16))
            else:
                assert params[k].dtype == torch.float32


def _jax_cast_storage(params):
    """The JAX driver's bf16 storage of the large leaves."""
    from uniter_tpu.training.driver import maybe_cast_param_storage

    return maybe_cast_param_storage(
        params, type("Opts", (), {"param_dtype": "bfloat16"})())


def _bridge_raw(tree):
    return state_dict_from_jax_params(jax.tree.map(np.asarray, tree))


def _master_state(seed=0):
    torch.manual_seed(seed)
    model = UniterForVisualQuestionAnswering(
        pconfig.tiny_config(**_master_cfg()), img_dim=MASTER_IMG,
        num_answer=N_ANS)
    opt = popt.build_optimizer(
        model, psched.get_lr_schedule(1e-3, 2, 6), fused=True, master=True,
        mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16)
    return pstep.TrainState(step=0, model=model, opt=opt)


def test_master_mode_exports_masters_and_resumes_bitwise(tmp_path):
    step = pstep.make_train_step(
        lambda m, b, g: (vqa_loss(m, b, g, N_ANS), {}))
    batches = [_tt(_master_batch(i)) for i in range(3)]

    def run(state, until):
        while state.step < until:
            state, _ = step(state, batches[state.step % 3], seed=7)
        return state

    straight = run(_master_state(), 6)
    first = run(_master_state(), 3)
    saver = TrainStateSaver(str(tmp_path))
    saver.save(3, first, seed=7)
    exported = torch.load(tmp_path / "ckpt" / "model_step_3.pt",
                          weights_only=True)
    assert all(v.dtype == torch.float32 for v in exported.values())
    for k, v in first.opt.masters().items():
        assert torch.equal(exported[k], v), k
    resumed = _master_state(seed=1)  # other initial weights
    assert saver.restore(resumed) is resumed and resumed.step == 3
    for k, v in first.opt.masters().items():
        assert torch.equal(resumed.opt.masters()[k], v), k
    run(resumed, 6)
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    for k, v in straight.opt.masters().items():
        assert torch.equal(resumed.opt.masters()[k], v), k
    sa, sb = straight.opt.state(), resumed.opt.state()
    for which in ("mu", "nu"):
        for k in sa[which]:
            assert torch.equal(sa[which][k], sb[which][k]), (which, k)


def test_master_mode_needs_fused_adamw():
    model = UniterForVisualQuestionAnswering(
        pconfig.tiny_config(), img_dim=IMG_DIM, num_answer=N_ANS)
    for kw in (dict(fused=False), dict(fused=True, optim="adam")):
        with pytest.raises(ValueError, match="fused adamw"):
            popt.build_optimizer(model, 1e-3, master=True, **kw)
    opts = type("O", (), dict(moment_dtype="float32", fused_adamw=0,
                              param_dtype="bfloat16", betas=[0.9, 0.98],
                              weight_decay=0.01, grad_norm=2.0,
                              optim="adamw"))()
    with pytest.raises(ValueError, match="--fused_adamw 1"):
        driver.optim_kwargs(opts)


# ---------------------------------------------------------------- remat

def test_remat_grads_match_jax():
    """tests/test_encoder.py test_remat_grads_match in the port: JAX
    ``remat=True`` against the port's remat, rate 0."""
    batch = _trunk_batch()
    jb = [jnp.asarray(batch[k]) for k in ("input_ids", "position_ids",
                                          "img_feat", "img_pos_feat",
                                          "attn_mask")]
    jmodel = JaxUniterModel(jax_tiny(remat=True, **NO_DROP), img_dim=16)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, *jb)["params"]
    jgrads = jax.grad(lambda p: jnp.sum(
        jmodel.apply({"params": p}, *jb) ** 2))(params)
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                    prefix="")
    model = UniterModel(pconfig.tiny_config(remat=True, **NO_DROP),
                        img_dim=16, pooler="pooler.dense.weight" in sd)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                          strict=True)
    assert model.encoder.remat
    out = model(*_trunk_args(batch), deterministic=False,
                generator=torch.Generator().manual_seed(0))
    out.square().sum().backward()
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads),
                                      prefix="")
    scale = float(np.sqrt(sum(np.square(v).sum() for v in want.values())))
    for k, p in model.named_parameters():
        if p.grad is None:  # unused (mask_embedding, the pooler)
            assert not want[k].any(), k
            continue
        d = np.abs(p.grad.numpy() - want[k]).max()
        assert d <= 1e-5 * max(scale, 1.0), (k, d, scale)


def _remat_run(remat, monkeypatch=None, naive=False):
    """One forward + backward of the tiny trunk at rate 0.1 from the step
    generator of (seed 3, step 0); (loss, grads by name, seeds drawn)."""
    torch.manual_seed(0)
    model = UniterModel(pconfig.tiny_config(remat=remat), img_dim=16)
    drawn = []
    real = D.draw_seed

    def count(gen):
        drawn.append(1)
        return real(gen)

    mp = pytest.MonkeyPatch()
    mp.setattr(D, "draw_seed", count)
    if naive:
        from torch.utils.checkpoint import checkpoint

        def forward(self, hidden, bias, deterministic=True, generator=None,
                    n_layers=None):
            # the trap: the seeds drawn inside the checkpointed call
            for layer in self.layer[:n_layers]:
                hidden = checkpoint(layer, hidden, bias, deterministic,
                                    generator, use_reentrant=False)
            return hidden

        mp.setattr(UniterEncoder, "forward", forward)
    try:
        out = model(*_trunk_args(_trunk_batch()), deterministic=False,
                    generator=pstep.step_generator(3, 0))
        loss = out.square().sum()
        loss.backward()
    finally:
        mp.undo()
    return (loss.detach(), {k: p.grad for k, p in model.named_parameters()},
            len(drawn))


def test_remat_replays_the_masks_bitwise():
    """Rate 0.1: remat draws each layer's seeds before its checkpoint, so
    the recompute sees the forward's masks: the loss and every gradient
    equal the non-remat run's bit for bit, from the same number of draws
    (2 embedding tails + 3 a layer). Drawn inside the checkpoint, the
    recompute draws 3 more a layer and the gradients belong to other
    masks."""
    loss0, g0, n0 = _remat_run(False)
    loss1, g1, n1 = _remat_run(True)
    assert n0 == n1 == 2 + 3 * 2
    assert torch.equal(loss0, loss1)
    used = [k for k in g0 if g0[k] is not None]
    assert [k for k in g1 if g1[k] is not None] == used
    for k in used:
        assert torch.equal(g0[k], g1[k]), k
    loss2, g2, n2 = _remat_run(True, naive=True)
    assert n2 == n0 + 3 * 2
    assert torch.equal(loss0, loss2)  # the forward is the same
    assert any(not torch.allclose(g0[k], g2[k]) for k in used)


def test_remat_step_is_the_plain_step():
    """A VQA train step with ``remat`` equals the step without it, bit for
    bit, at dropout 0.1 (the config flag reaches the trunk)."""
    def run(remat):
        torch.manual_seed(0)
        model = UniterForVisualQuestionAnswering(
            pconfig.tiny_config(remat=remat), img_dim=IMG_DIM,
            num_answer=N_ANS)
        opt = popt.build_optimizer(model, 1e-3, fused=True)
        state = pstep.TrainState(step=0, model=model, opt=opt)
        step = pstep.make_train_step(
            lambda m, b, g: (vqa_loss(m, b, g, N_ANS), {}))
        for b in BATCHES[:2]:
            state, m = step(state, _tt(b), seed=5)
        return float(m["loss"]), state.model.state_dict()

    (la, a), (lb, b) = run(False), run(True)
    assert la == lb
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------- wire

@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_wire_codec_matches_jax(dtype):
    from uniter_tpu.training.loop import _dequant_q8, _quantize_wire_int8
    from uniter_tpu_torch.training.loop import (dequantize_wire_int8,
                                                quantize_wire_int8)

    rng = np.random.RandomState(0)
    v = (rng.randn(3, 7, 96) * rng.rand(3, 7, 1) * 4).astype(dtype)
    v[0, 0] = 0.0  # an all-zero row: the 1e-12 floor
    q, scale = quantize_wire_int8(v)
    jq, js = _quantize_wire_int8(v)
    assert q.dtype == jq.dtype == np.int8 and scale.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale, js)
    got = dequantize_wire_int8(torch.from_numpy(q), torch.from_numpy(scale),
                               torch.float32).numpy()
    want = np.asarray(_dequant_q8(jnp.asarray(jq), jnp.asarray(js),
                                  dtype_name="float32"))
    np.testing.assert_allclose(got, want, rtol=2 ** -24, atol=0)
    bound = np.abs(v.astype(np.float32)).max(-1, keepdims=True) / 254
    assert (np.abs(got - v.astype(np.float32)) <= bound * (1 + 1e-6)).all()
    got16 = dequantize_wire_int8(torch.from_numpy(q),
                                 torch.from_numpy(scale), torch.bfloat16)
    want16 = np.asarray(_dequant_q8(jnp.asarray(jq), jnp.asarray(js),
                                    dtype_name="bfloat16"), np.float32)
    np.testing.assert_allclose(got16.float().numpy(), want16, rtol=2 ** -8,
                               atol=0)


def test_wire_codec_through_the_batch_copy():
    """``train_batch_to_device``: with int8 only ``img_feat`` changes, to
    the transfer dtype; the default path is the plain cast."""
    batch = dict(BATCHES[0])
    cast = train_batch_to_device(batch, torch.device("cpu"), torch.bfloat16)
    int8 = train_batch_to_device(batch, torch.device("cpu"), torch.bfloat16,
                                 "int8")
    assert sorted(int8) == sorted(cast) == sorted(batch)
    for k in batch:
        if k != "img_feat":
            assert torch.equal(int8[k], cast[k]), k
    assert int8["img_feat"].dtype == torch.bfloat16
    err = (int8["img_feat"].float() - torch.from_numpy(batch["img_feat"]))
    row = np.abs(batch["img_feat"]).max(-1, keepdims=True)
    # the int8 step, plus the bf16 roundings of the scale and the product
    # (at most 2^-8 of max|row| each)
    assert (err.abs().numpy() <= row / 254 + row * 2 * 2 ** -8).all()
    assert torch.equal(cast["img_feat"],
                       torch.from_numpy(batch["img_feat"]).bfloat16())
    with pytest.raises(ValueError, match="wire_codec"):
        train_batch_to_device(batch, torch.device("cpu"), None, "int4")


# ---------------------------------------------------------------- saves

def test_async_save_snapshot_survives_in_place_updates(tmp_path,
                                                       monkeypatch):
    """tests/test_training.py test_async_save_is_durable_before_read in the
    port: the optimizer updates parameters and moments in place, so the
    parameters are changed while the write is still pending; the restore
    reads the values of the save."""
    state = _master_state()
    step = pstep.make_train_step(
        lambda m, b, g: (vqa_loss(m, b, g, N_ANS), {}))
    state, _ = step(state, _tt(_master_batch(0)), seed=1)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    want.update({k: v.clone() for k, v in state.opt.masters().items()})
    want_mu = {k: v.clone() for k, v in state.opt.state()["mu"].items()}
    real = torch.save

    def slow(obj, path):
        time.sleep(0.2)
        real(obj, path)

    monkeypatch.setattr(torch, "save", slow)
    saver = TrainStateSaver(str(tmp_path))
    saver.save(1, state, seed=1, best_value=0.5, block=False)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for v in state.opt.masters().values():
            v.add_(1.0)
        for m in state.opt.state()["mu"].values():
            m.add_(1.0)
    assert saver._thread.is_alive()  # the write was still pending
    assert saver.latest_step() == 1
    assert saver.best_info() == {"step": 1, "value": 0.5}
    fresh = _master_state(seed=2)
    saver.restore(fresh)
    got = {**fresh.model.state_dict(), **fresh.opt.masters()}
    for k, v in want.items():
        assert torch.equal(got[k].float(), v.float()), k
    for k, v in want_mu.items():
        assert torch.equal(fresh.opt.state()["mu"][k], v), k
    for name in ("model_step_1.pt", "model_step_best.pt"):
        w = torch.load(tmp_path / "ckpt" / name, weights_only=True)
        for k in state.opt.masters():
            assert torch.equal(w[k], want[k]), (name, k)

    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    saver.save(2, state, block=False)
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    saver.wait()  # raised once


# ---------------------------------------------------------------- CLIs

def test_check_unported_raises_for_fsdp_alone(jax_params):
    """``--fsdp`` was the one flag the drivers refused; it is ported now
    and no flag raises: with every other flag it parses into the optimizer
    options, and at world size 1 (no process group) a master-mode step with
    the state of every parameter of 64 elements or more in sharded groups
    equals the step without ``--fsdp`` (the groups split the norm's sum,
    1e-6)."""
    parser = driver.add_common_args(__import__("argparse").ArgumentParser())
    flags = ["--remat", "--param_dtype", "bfloat16", "--wire_codec", "int8",
             "--dropout_impl", "u8", "--optim", "adamax", "--profile_dir",
             "p"]
    kw = driver.optim_kwargs(parser.parse_args(
        flags + ["--fsdp", "--fsdp_min_size", "64"]))
    assert kw["fsdp"] and kw["fsdp_min_size"] == 64
    assert not driver.optim_kwargs(parser.parse_args(flags))["fsdp"]
    runs = {}
    for fsdp in ([], ["--fsdp", "--fsdp_min_size", "64"]):
        opts = parser.parse_args(["--param_dtype", "bfloat16", *fsdp])
        model = _port_model(jax_params, **NO_DROP)
        opt = popt.build_optimizer(model, 1e-3, **driver.optim_kwargs(opts))
        assert any(g["sharded"] for g in opt.groups) == bool(fsdp)
        state = pstep.TrainState(step=0, model=model, opt=opt)
        step = pstep.make_train_step(
            lambda m, b, g: (vqa_loss(m, b, g, N_ANS), {}))
        state, m = step(state, _tt(BATCHES[0]), 0)
        runs[bool(fsdp)] = (float(m["loss"]), opt.masters(), {
            k: v.float() for k, v in model.state_dict().items()})
    assert runs[True][0] == runs[False][0]
    assert runs[True][1].keys() == runs[False][1].keys()
    for k, v in runs[False][1].items():
        np.testing.assert_allclose(runs[True][1][k], v, atol=1e-6, err_msg=k)
    for k, v in runs[False][2].items():
        np.testing.assert_allclose(runs[True][2][k], v, atol=1e-6, err_msg=k)


FLAGS = ["--remat", "--param_dtype", "bfloat16", "--fused_adamw", "1",
         "--wire_codec", "int8", "--dropout_impl", "u16"]
CLI_WORDS = ["what", "color", "is", "the", "dog", "cat", "red", "blue", "a",
             "on", "hat", "##s", "##ing", "wear", "person", "?", ","]
CLI_ANSWERS = ["red", "blue", "dog", "cat"]


def _run(args):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def _trace_steps(profile_dir):
    files = [f for f in os.listdir(profile_dir)
             if f.endswith(".pt.trace.json")]
    assert len(files) == 1, files
    with open(os.path.join(profile_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    return sum(e.get("name") == "loop.step"
               and e.get("cat") == "user_annotation" for e in events)


def test_cli_prepro_to_train_with_every_flag_to_inference(tmp_path):
    """Raw annotations and npz features through the port's own
    ``convert_imgdir`` and ``prepro``, then ``train_vqa`` with every
    single-card flag (3 steps; the profiler window of a 3-step run is its
    steps 1-2), a resume to 5 and ``inf_vqa`` on the fp32 export."""
    rng = np.random.RandomState(0)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "!"] + CLI_WORDS
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    npz = tmp_path / "npz"
    npz.mkdir()
    for i in range(6):
        nbb = rng.randint(4, 12)
        np.savez(npz / f"coco_{i:012}.npz",
                 features=rng.randn(nbb, 2048).astype(np.float32),
                 norm_bb=rng.rand(nbb, 6).astype(np.float32),
                 conf=np.linspace(1, 0.1, nbb).astype(np.float32),
                 soft_labels=rng.rand(nbb, 1601).astype(np.float32))
    qs = [{"question_id": i, "image_id": i % 6, "question": " ".join(
        rng.choice(CLI_WORDS[:11] + ["hats", "wearing", "zebra"],
                   rng.randint(3, 9)))} for i in range(24)]
    (tmp_path / "q.json").write_text(json.dumps({"questions": qs}))
    anns = [{"question_id": i, "answers": [
        {"answer": CLI_ANSWERS[i % 4]}] * 3} for i in range(24)]
    (tmp_path / "a.json").write_text(json.dumps({"annotations": anns}))
    (tmp_path / "ans2label.json").write_text(json.dumps(
        {a: i for i, a in enumerate(CLI_ANSWERS)}))
    img, txt = str(tmp_path / "img"), str(tmp_path / "txt")
    proc = _run(["-m", "uniter_tpu_torch.convert_imgdir", "--img_dir",
                 str(npz), "--output", img, "--max_bb", "10", "--min_bb",
                 "3", "--nproc", "2"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    proc = _run(["-m", "uniter_tpu_torch.prepro", "--task", "vqa",
                 "--annotation", str(tmp_path / "q.json"),
                 "--vqa_annotations", str(tmp_path / "a.json"),
                 "--ans2label", str(tmp_path / "ans2label.json"),
                 "--output", txt, "--toker", str(tmp_path / "vocab.txt")])
    assert proc.returncode == 0, proc.stderr[-3000:]
    model_cfg = dict(pconfig.tiny_config(hidden_size=48,
                                         intermediate_size=96).to_dict(),
                     vocab_size=len(vocab))
    (tmp_path / "model.json").write_text(json.dumps(model_cfg))
    out = tmp_path / "run"
    conf = dict(train_txt_db=txt, train_img_db=img, val_txt_db=txt,
                val_img_db=img, model_config=str(tmp_path / "model.json"),
                output_dir=str(out),
                ans2label=str(tmp_path / "ans2label.json"),
                train_batch_size=256, val_batch_size=512, max_bb=10,
                min_bb=3, n_workers=0, warmup_steps=2, valid_steps=2,
                log_steps=1, num_train_steps=3, device="cpu", dtype="float32",
                profile_dir=str(tmp_path / "prof"))
    path = tmp_path / "train.json"
    path.write_text(json.dumps(conf))
    proc = _run(["-m", "uniter_tpu_torch.train_vqa", "--config", str(path),
                 *FLAGS])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "profiler trace written" in proc.stderr
    assert _trace_steps(tmp_path / "prof") == 2
    assert "span loop.step: 2," in proc.stderr
    hps = json.load(open(out / "log" / "hps.json"))
    assert (hps["remat"], hps["param_dtype"], hps["wire_codec"],
            hps["dropout_impl"]) == (True, "bfloat16", "int8", "u16")
    assert json.load(open(out / "log" / "model.json"))["remat"] is True
    w = torch.load(out / "ckpt" / "model_step_3.pt", weights_only=True)
    assert all(v.dtype == torch.float32 for v in w.values())
    proc = _run(["-m", "uniter_tpu_torch.train_vqa", "--config", str(path),
                 *FLAGS, "--num_train_steps", "5"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed from step 3" in proc.stderr
    proc = _run(["-m", "uniter_tpu_torch.inf_vqa", "--txt_db", txt,
                 "--img_db", img, "--train_dir", str(out), "--output_dir",
                 str(tmp_path / "ans"), "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    answers = json.load(open(tmp_path / "ans" / "results.json"))
    assert sorted(int(a["question_id"]) for a in answers) == list(range(24))
    assert {a["answer"] for a in answers} <= set(CLI_ANSWERS)
    # --optim adam (master weights need the fused AdamW, so not with it)
    proc = _run(["-m", "uniter_tpu_torch.train_vqa", "--config", str(path),
                 "--remat", "--wire_codec", "int8", "--dropout_impl", "u8",
                 "--optim", "adam", "--num_train_steps", "2",
                 "--output_dir", str(tmp_path / "run_adam"),
                 "--profile_dir", str(tmp_path / "prof_adam")])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "training finished at step 2" in proc.stderr


def test_pretrain_runs_every_flag(dbs):  # noqa: F811
    """The ``MixedTaskLoop`` path: ``pretrain`` with every single-card flag
    for 4 steps (mlm / itm / mrfr / mrc-kl over two corpora) profiles its
    window (steps 2-3) and exports fp32 masters; then 2 steps with
    ``--optim adamax``."""
    from uniter_tpu_torch import pretrain

    prof = str(dbs / "prof")
    _, opts = _pretrain_opts(
        dbs, "flags", 4, remat=True, param_dtype="bfloat16", fused_adamw=1,
        wire_codec="int8", dropout_impl="u8", profile_dir=prof)
    state = pretrain.main(opts)
    assert state.step == 4 and state.model.uniter.config.remat
    # img_linear (2048 x 48) and the region classifier are stored bf16
    assert "uniter.img_embeddings.img_linear.weight" in state.opt.masters()
    assert _trace_steps(prof) == 2
    w = torch.load(dbs / "flags" / "ckpt" / "model_step_4.pt",
                   weights_only=True)
    for k, v in state.opt.masters().items():
        assert w[k].dtype == torch.float32 and torch.equal(w[k], v), k
    _, opts = _pretrain_opts(dbs, "adamax", 2, remat=True, optim="adamax",
                             wire_codec="int8", dropout_impl="u16")
    state = pretrain.main(opts)
    assert state.step == 2 and state.opt.optim == "adamax"
