"""The port's LayerNorm (plain version, K8 wrapper and its autograd
Function) and the ``layer_norm_impl`` policy against the JAX package, on
the CPU.

Inputs come from a seed through numpy. The JAX side runs
``_layer_norm_xla`` and the Pallas kernel in interpret mode
(``UNITER_PALLAS_INTERPRET=1``). On the CPU the K8 wrapper takes its plain
version, so what is held here is the arithmetic around the kernel: the
forward to 1e-5 (fp32 rounding of another summation order), the backward
of ``LayerNormFunction`` against ``jax.vjp`` of the JAX custom VJP to 1e-5
and against float64 autograd.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uniter_tpu_torch import config as pconfig
from uniter_tpu_torch.ops import layer_norm as pln

# ``uniter_tpu.ops`` re-exports the function under the module's name
jln = importlib.import_module("uniter_tpu.ops.layer_norm")

torch.set_num_threads(2)

SHAPES = [(16, 64), (3, 8, 128), (24, 768)]


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    h = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, w, b, g


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("UNITER_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("shape", SHAPES)
def test_layer_norm_matches_jax_xla_and_pallas(interpret, shape):
    x, w, b, _ = _inputs(shape)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-12)
    want_xla = np.asarray(jln._layer_norm_xla(*args))
    want_pallas = np.asarray(jln._layer_norm_pallas(*args))
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    for impl in ("xla", "cuda"):
        got = pln.layer_norm(tx, tw, tb, 1e-12, impl=impl).numpy()
        np.testing.assert_allclose(got, want_xla, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, want_pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(pln.layer_norm_fwd(tx, tw, tb).numpy(),
                               want_pallas, atol=1e-5, rtol=0)
    assert pln.layer_norm_fwd.launches == 0  # a CPU tensor never launches


def test_layer_norm_bf16_statistics_in_fp32():
    x, w, b, _ = _inputs((16, 64), seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jln._layer_norm_xla(
        xb, jnp.asarray(w), jnp.asarray(b), 1e-12).astype(jnp.float32))
    got = pln.layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                         torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the same fp32 value: at most one step apart
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7,
                               atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_function_backward_matches_jax_vjp(interpret, shape):
    x, w, b, g = _inputs(shape, seed=2)
    _, vjp = jax.vjp(
        lambda xx, ww, bb: jln._layer_norm_pallas_vjp(xx, ww, bb, 1e-12),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = pln.LayerNormFunction.apply(tx, tw, tb, 1e-12)
    y.backward(torch.from_numpy(g))
    for got, ref, name in zip((tx.grad, tw.grad, tb.grad), want,
                              ("dx", "dw", "db")):
        np.testing.assert_allclose(
            got.numpy(), ref, atol=1e-5 * max(np.abs(ref).max(), 1.0),
            rtol=0, err_msg=name)
    dx, dw, db = pln._layer_norm_bwd_torch(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g))
    assert torch.equal(dx, tx.grad) and torch.equal(dw, tw.grad)
    assert torch.equal(db, tb.grad)


def test_function_backward_matches_float64_autograd():
    x, w, b, g = _inputs((12, 64), seed=3)
    t64 = [torch.from_numpy(a).double().requires_grad_() for a in (x, w, b)]
    pln._layer_norm_torch(*t64, 1e-12).backward(torch.from_numpy(g).double())
    t32 = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    pln.layer_norm(*t32, 1e-12, impl="cuda").backward(torch.from_numpy(g))
    for a, ref in zip(t32, t64):
        np.testing.assert_allclose(
            a.grad.numpy(), ref.grad.numpy(),
            atol=1e-5 * max(ref.grad.abs().max().item(), 1.0), rtol=0)


def test_function_gradcheck():
    """The explicit backward formula against numerical differences in
    float64 (the plain forward keeps float64)."""
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.randn(5, 8), dtype=torch.float64,
                     requires_grad=True)
    w = torch.tensor(1.0 + 0.1 * rng.randn(8), dtype=torch.float64,
                     requires_grad=True)
    b = torch.tensor(0.1 * rng.randn(8), dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda *a: pln.LayerNormFunction.apply(*a, 1e-12), (x, w, b),
        eps=1e-6, atol=1e-5)


def test_wrapper_checks_and_unknown_impl():
    x, w, b, _ = _inputs((4, 64))
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    with pytest.raises(ValueError, match="unknown layer_norm impl"):
        pln.layer_norm(tx, tw, tb, impl="pallas")
    with pytest.raises(ValueError, match=r"weight and bias must be \[64\]"):
        pln.layer_norm_fwd(tx, tw[:32], tb)
    with pytest.raises(ValueError, match="non-empty"):
        pln.layer_norm_fwd(tx[:0], tw, tb)


def _misaligned(t):
    """``t``'s values in a view 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)[2:2 + t.numel()]
    return flat.view(t.shape).copy_(t)


def test_one_look_check_sends_every_bad_input_to_the_full_checks():
    """K8's launch path looks once at each tensor (``_fits``, the tails'
    ``_launchable`` for one kernel); every input it refuses is refused by
    the full checks (``_check``, then ``_check_card`` on a card), with the
    errors a card input raised before."""
    x, w, b, _ = _inputs((4, 64))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    good = (tx.bfloat16(), tw, tb)
    assert pln._fits(*good) and pln._fits(tx, tw, tb)
    pln._check(*good)
    pln._check_card(*good)
    raising = {
        "float16": ((tx.half(), tw, tb), TypeError),
        "float64": ((tx.double(), tw, tb), TypeError),
        "bf16 weight": ((tx, tw.bfloat16(), tb), TypeError),
        "H 4096": ((torch.zeros(2, 4096), torch.ones(4096),
                    torch.zeros(4096)), ValueError),
        "H 66": ((torch.zeros(2, 66), torch.ones(66), torch.zeros(66)),
                 ValueError),
        "strided x": ((tx.t().contiguous().t(), tw, tb), ValueError),
        "misaligned x": ((_misaligned(tx), tw, tb), ValueError),
        "strided w": ((tx, torch.stack([tw, tw], 1)[:, 0], tb), ValueError),
        "b shape": ((tx, tw, tb[:32]), ValueError),
        "a scalar": ((tx[0, 0], tw, tb), ValueError),
        "no rows": ((tx[:0], tw, tb), ValueError),
        "two devices": ((tx, tw.to("meta"), tb), ValueError)}
    for name, (args, err) in raising.items():
        assert not pln._fits(*args), name
        with pytest.raises(err):
            pln._check(*args)
            pln._check_card(*args)
    # the short path also asks for a card: other devices go to the full
    # checks, which take the CPU (the plain version) and refuse the rest
    assert torch.equal(pln.layer_norm_fwd(tx, tw, tb),
                       pln._layer_norm_torch(tx, tw, tb))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        pln.layer_norm_fwd(*(a.to("meta") for a in (tx, tw, tb)))


@pytest.mark.parametrize("given,device,want", [
    ("xla", "cpu", "xla"), ("pallas", "cpu", "xla"), ("cuda", "cpu", "xla"),
    ("xla", "cuda", "xla"), ("pallas", "cuda", "cuda"),
    ("cuda", "cuda:0", "cuda")])
def test_resolve_layer_norm_impl(given, device, want):
    cfg = pconfig.tiny_config(layer_norm_impl=given)
    for training in (False, True):
        got = pconfig.resolve_kernel_policies(cfg, device, training=training)
        assert got.layer_norm_impl == want


def test_resolve_rejects_unknown_and_from_dict_keeps_the_field():
    with pytest.raises(ValueError, match="layer_norm_impl"):
        pconfig.resolve_kernel_policies(
            pconfig.tiny_config(layer_norm_impl="auto"), "cpu")
    raw = dict(hidden_size=64, layer_norm_impl="pallas", ffn_impl="pallas",
               scan_unroll=2)
    cfg = pconfig.UniterConfig.from_dict(raw)
    assert cfg.layer_norm_impl == "pallas"
    # the FFN policy travels too and resolves as the LayerNorm's does
    assert cfg.ffn_impl == "pallas" and "scan_unroll" not in cfg.to_dict()
    assert pconfig.resolve_kernel_policies(cfg, "cpu").ffn_impl == "xla"
    assert pconfig.resolve_kernel_policies(cfg, "cuda").ffn_impl == "cuda"
    with pytest.raises(ValueError, match="ffn_impl"):
        pconfig.resolve_kernel_policies(cfg.replace(ffn_impl="tpu"), "cpu")
    assert pconfig.UniterConfig().layer_norm_impl == "xla"
    assert pconfig.UniterConfig().ffn_impl == "xla"


def test_modules_follow_layer_norm_impl():
    """Every LayerNorm the encoder and the heads build carries the
    config's policy; on the CPU both policies give the same numbers."""
    from uniter_tpu_torch.models.encoder import LayerNorm
    from uniter_tpu_torch.models.pretrain import UniterForPretraining

    torch.manual_seed(0)
    plain = UniterForPretraining(pconfig.tiny_config(), img_dim=32,
                                 img_label_dim=11)
    kern = UniterForPretraining(pconfig.tiny_config(layer_norm_impl="cuda"),
                                img_dim=32, img_label_dim=11)
    kern.load_state_dict(plain.state_dict(), strict=True)
    lns = [m for m in kern.modules() if isinstance(m, LayerNorm)]
    # 2 embedding tails, img/pos LNs, 2 per layer, 3 heads
    assert len(lns) == 4 + 2 * 2 + 3
    assert all(m.impl == "cuda" for m in lns)
    assert all(m.impl == "xla" for m in plain.modules()
               if isinstance(m, LayerNorm))
    rng = np.random.RandomState(0)
    batch = dict(
        input_ids=torch.from_numpy(rng.randint(1, 500, (2, 6))),
        position_ids=torch.arange(6).repeat(2, 1),
        img_feat=torch.from_numpy(rng.randn(2, 4, 32).astype(np.float32)),
        img_pos_feat=torch.from_numpy(rng.rand(2, 4, 7).astype(np.float32)),
        attn_mask=torch.ones(2, 10, dtype=torch.long),
        mrm_pos=torch.zeros(2, 2, dtype=torch.long))
    a = plain(batch, "mrc", False, deterministic=True)
    b = kern(batch, "mrc", False, deterministic=True)
    assert torch.equal(a, b)
