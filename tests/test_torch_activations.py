"""The port's erf GELU and its in-place inference route, on the CPU.

* ``gelu_`` (the library's erf GELU, in place) against the composition
  ``gelu`` and the erf formula in float64, the JAX package's ``gelu`` in
  fp32; in bf16 within one bf16 rounding of the float64 value of the same
  inputs, and never farther from it than ``gelu`` (five roundings);
  ``gelu``'s gradient against float64 finite differences.
* ``BertIntermediate``: a forward that records no gradient (``no_grad``
  and ``inference_mode``) runs ``gelu_`` in FC1's output; a forward that
  records one runs ``gelu`` out of place, and its backward runs; other
  activations keep their own function.
* A 12-layer scorer tile takes the in-place route at all 12 FFNs (11
  layers and the CLS layer) and scores within 1e-6 of the same tile run
  with a gradient recorded (``gelu``).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uniter_tpu_torch import config as pconfig
from uniter_tpu_torch.models.encoder import BertIntermediate
from uniter_tpu_torch.ops import activations as act

torch.set_num_threads(2)


def _x(n=4099, seed=0):
    """Values across GELU's range: N(0, 3), the tails, zero, exact halves."""
    rng = np.random.RandomState(seed)
    x = 3.0 * rng.randn(n)
    x[:8] = [0.0, -0.5, 0.5, -9.0, 9.0, -30.0, 30.0, -5.5]
    return torch.from_numpy(x)


def _formula(x):
    """The erf GELU spelled out, in float64."""
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def test_gelu_in_place_matches_the_composition_and_jax():
    from uniter_tpu.ops.activations import gelu as jgelu

    x64 = _x()
    y64 = x64.clone()
    assert act.gelu_(y64) is y64
    torch.testing.assert_close(y64, _formula(x64), rtol=1e-12, atol=1e-15)
    x = x64.float()
    y = act.gelu_(x.clone())
    assert y.dtype == torch.float32
    # 1 + erf cancels in the negative tail: an fp32 rounding of erf is
    # |x| 2^-25 there, under 1e-6 over these inputs
    torch.testing.assert_close(y, act.gelu(x), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(y.double(), _formula(x.double()), rtol=1e-6,
                               atol=1e-6)
    # XLA's CPU erf stops short of -1 past |x| 8 (gelu(-30) reads -2.7e-6)
    near = x.abs() <= 8
    np.testing.assert_allclose(y[near].numpy(), np.asarray(jgelu(jnp.asarray(
        x[near].numpy()))), rtol=1e-6, atol=1e-6)


def test_gelu_in_place_in_bf16_is_one_rounding_of_the_exact_value():
    xb = _x().to(torch.bfloat16)
    exact = _formula(xb.double())
    y = act.gelu_(xb.clone())
    assert y.dtype == torch.bfloat16
    err = (y.double() - exact).abs()
    # one bf16 rounding (half a step: at most 2^-8 of the value) of an fp32
    # result (1e-6, above)
    assert bool((err <= 2.0**-8 * exact.abs() + 1e-6).all())
    chain = (act.gelu(xb).double() - exact).abs()
    assert err.max() <= chain.max()
    assert err.sum() < chain.sum()  # the composition rounds five times


def test_gelu_gradient_matches_finite_differences():
    x = _x(64, seed=1)[8:].clone().requires_grad_()
    assert torch.autograd.gradcheck(act.gelu, (x,))
    act.gelu(x).sum().backward()
    v = x.detach()
    want = 0.5 * (1.0 + torch.erf(v / math.sqrt(2.0))) + v * torch.exp(
        -0.5 * v * v) / math.sqrt(2.0 * math.pi)
    torch.testing.assert_close(x.grad, want, rtol=1e-12, atol=1e-14)


def _intermediate(hidden_act="gelu", dtype=torch.float32):
    torch.manual_seed(0)
    cfg = pconfig.tiny_config(hidden_act=hidden_act)
    return BertIntermediate(cfg), torch.randn(2, 5, cfg.hidden_size,
                                              dtype=dtype)


def _fc1_storage(mod):
    """The storages FC1's outputs were written to, one a forward."""
    ptrs = []
    mod.dense.register_forward_hook(lambda m, i, o: ptrs.append(o.data_ptr()))
    return ptrs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_inference_runs_the_gelu_in_place(mode, dtype):
    mod, x = _intermediate(dtype=dtype)
    mod.to(dtype)
    with torch.no_grad():
        want = act.gelu_(mod.dense(x))
    fc1 = _fc1_storage(mod)
    with getattr(torch, mode)():
        out = mod(x)
    assert fc1 and out.data_ptr() == fc1[0]
    assert out.dtype == dtype and torch.equal(out, want)


def test_a_recorded_gradient_keeps_fc1_output():
    mod, x = _intermediate()
    fc1 = _fc1_storage(mod)
    out = mod(x.requires_grad_())
    assert out.requires_grad and out.data_ptr() != fc1[0]
    with torch.no_grad():
        assert torch.equal(out, act.gelu(mod.dense(x)))
    out.sum().backward()
    assert x.grad is not None and mod.dense.weight.grad is not None


def test_other_activations_keep_their_own_function():
    mod, x = _intermediate("relu")
    fc1 = _fc1_storage(mod)
    with torch.inference_mode():
        out = mod(x)
        assert torch.equal(out, torch.relu(mod.dense(x)))
    assert out.data_ptr() != fc1[0]


def test_a_scorer_tile_runs_the_gelu_in_place_at_every_layer():
    """A 12-layer retrieval model's scoring tile (``_Scorer.tile``: 11
    layers through the trunk, the last as ``BertLayerCLS``): every FFN's
    GELU in place under ``inference_mode``, none with a gradient recorded,
    and the same scores within 1e-6."""
    from uniter_tpu_torch.models.itm import UniterForImageTextRetrieval
    from uniter_tpu_torch.utils.itm_fast import _Scorer

    torch.manual_seed(0)
    model = UniterForImageTextRetrieval(
        pconfig.tiny_config(num_hidden_layers=12), img_dim=16).eval()
    scorer = _Scorer(model)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(1, 500, (2, 6)))
    feat = torch.from_numpy(rng.randn(3, 4, 16).astype(np.float32))
    pos = torch.from_numpy(rng.rand(3, 4, 7).astype(np.float32))
    t_mask = torch.ones(2, 6, dtype=torch.int32)
    t_mask[1, 4:] = 0
    i_mask = torch.ones(3, 4, dtype=torch.int32)
    i_mask[2, 3:] = 0
    # the model's 12 and the CLS layer's copy of the last
    ffns = [m for m in (*model.modules(), *scorer.cls_layer.modules())
            if isinstance(m, BertIntermediate)]
    assert len(ffns) == 13
    seen = []
    for m in ffns:
        m.dense.register_forward_hook(
            lambda mod, i, o: seen.append(("fc1", o.data_ptr())))
        m.register_forward_hook(
            lambda mod, i, o: seen.append(("act", o.data_ptr())))

    def tile():
        seen.clear()
        out = scorer.tile(scorer.embed_txt(ids), t_mask,
                          scorer.embed_img(feat, pos), i_mask)
        pairs = list(zip(seen[::2], seen[1::2]))
        assert len(pairs) == 12
        return out, [f[1] == a[1] for f, a in pairs]

    with torch.inference_mode():
        got, in_place = tile()
    with torch.enable_grad():
        want, kept = tile()
    assert all(in_place) and not any(kept)
    assert got.shape == (2, 3)
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=1e-6)
