"""The port's attention (``uniter_tpu_torch.ops.attention``) against the JAX
package's ``multi_head_attention``, on the CPU in fp32.

The JAX side runs both its XLA path and its Pallas kernel (under the
Pallas interpreter, as tests/test_pallas_interpret.py runs it). The port's
plain version ``_mha_torch`` and its kernel wrapper ``mha_fwd`` (which
takes the plain version for a CPU tensor) must agree with both to
atol = rtol = 1e-5, the fp32 rounding of a different summation order.
The CUDA kernel itself is held against ``_mha_torch`` on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Rows whose keys are all padding get their own bound. Their scores sit at
-10000 + O(1), where the fp32 grid is 2**-10 wide, so two correct fp32
implementations that round q.k differently can land one grid step apart
on a score: each probability may then move by a factor exp(+-2**-10),
and the output by up to 2**-9 * max|v| (measured: about 1e-4 at
S=104, D=64, against 1e-6 on rows with a valid key). The test batch holds
two such rows: row 0 with a zero query, where every score is exactly
-10000 and the result is exactly the uniform average of v (held to 1e-5),
and row 1 with a random query (held to the grid bound).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uniter_tpu.ops.attention import multi_head_attention as jax_mha
from uniter_tpu_torch.ops import attention as port

torch.set_num_threads(2)

ATOL = RTOL = 1e-5


def _inputs(b, s, h, d, seed=0):
    """q/k/v [B,S,H,D] and an additive bias with ragged key lengths and
    padded keys; rows 0 and 1 are all padding, row 0 with a zero query."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    lens = rng.randint(1, s + 1, size=b)
    lens[:2] = 0
    q[0] = 0.0
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.float32)
    bias = ((1.0 - mask) * -10000.0).astype(np.float32)
    return q, k, v, bias


def _assert_close(out, ref, v, atol=ATOL, rtol=RTOL):
    """``atol``/``rtol`` on every row but row 1; row 1 (all padding, random
    query) to the fp32 grid bound at -10000 (module docstring)."""
    keep = [i for i in range(out.shape[0]) if i != 1]
    np.testing.assert_allclose(out[keep], ref[keep], atol=atol, rtol=rtol)
    assert np.abs(out[1] - ref[1]).max() <= 2.0**-9 * np.abs(v[1]).max() + atol
    # row 0 is the uniform average over all S keys, not NaN or zero
    np.testing.assert_allclose(out[0], v[0].mean(axis=0)[None].repeat(
        out.shape[1], 0), atol=atol, rtol=rtol)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("UNITER_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("s", [13, 24])
def test_mha_matches_jax(jax_impl, s, pallas_interpret):
    q, k, v, bias = _inputs(3, s, 4, 8, seed=s)
    ref = np.asarray(jax_mha(*(jnp.asarray(a) for a in (q, k, v, bias)),
                             impl=jax_impl))
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    _assert_close(port._mha_torch(tq, tk, tv, tb).numpy(), ref, v)
    before = port.mha_fwd.launches
    for impl in ("cuda", "xla"):
        out = port.multi_head_attention(tq, tk, tv, tb, impl=impl).numpy()
        _assert_close(out, ref, v)
    assert port.mha_fwd.launches == before  # CPU tensors never launch


def test_mha_strided_views_match():
    """fused_qkv hands the kernel strided views of one [B,S,3*H*D]
    projection; the wrapper takes them as they are."""
    q, k, v, bias = _inputs(2, 16, 4, 8)
    qkv = torch.from_numpy(np.concatenate(
        [a.reshape(2, 16, 32) for a in (q, k, v)], axis=-1))
    views = [qkv[..., i * 32:(i + 1) * 32].view(2, 16, 4, 8) for i in range(3)]
    assert not views[0].is_contiguous()
    out = port.mha_fwd(*views, torch.from_numpy(bias))
    ref = port._mha_torch(*(torch.from_numpy(a) for a in (q, k, v)),
                          torch.from_numpy(bias))
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "seq", "bias_shape",
                                 "inner_stride"])
def test_mha_fwd_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(2, 16, 4, 8))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = (t[..., :6] for t in (q, k, v))
    elif bad == "seq":  # 1,040 positions: past the forward's 1,024
        q, k, v = (t.repeat(1, 65, 1, 1) for t in (q, k, v))
        bias = bias.repeat(1, 65)
    elif bad == "bias_shape":
        bias = bias[:, :8]
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        port.mha_fwd(q, k, v, bias)


def test_attention_dropout_waits_for_training_slice():
    """Live attention dropout needs the call's seed; deterministic calls
    ignore the rate; a live call applies the seed's Philox mask, the same
    through the plain version and the kernel wrapper."""
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 8))
    with pytest.raises(ValueError):
        port.multi_head_attention(q, k, v, bias, dropout_rate=0.1,
                                  deterministic=False)
    # deterministic calls ignore the rate
    torch.testing.assert_close(
        port.multi_head_attention(q, k, v, bias, dropout_rate=0.1),
        port._mha_torch(q, k, v, bias), atol=0, rtol=0)
    outs = [port.multi_head_attention(q, k, v, bias, impl=impl,
                                      dropout_rate=0.1, deterministic=False,
                                      seed=5) for impl in ("xla", "cuda")]
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    torch.testing.assert_close(outs[0], port._mha_torch(q, k, v, bias, 0.1, 5),
                               atol=0, rtol=0)
    assert not torch.equal(outs[0], port._mha_torch(q, k, v, bias))


def _bwd_inputs(b, s, h, d, seed=0):
    """As ``_inputs`` plus an output gradient g, with only row 0 all padding
    (zero query, so its scores are exactly -10000): every other row has a
    valid key. Padded keys in the other rows are included."""
    q, k, v, bias = _inputs(b, s, h, d, seed)
    bias[1] = 0.0
    bias[1, s // 2:] = -10000.0
    g = np.random.RandomState(seed + 1).randn(b, s, h, d).astype(np.float32)
    return q, k, v, bias, g


def _port_grads(q, k, v, bias, g, fn):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (fn(tq, tk, tv, torch.from_numpy(bias)) * torch.from_numpy(g)
     ).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("s", [13, 24])
def test_mha_backward_matches_jax_grad(jax_impl, s, pallas_interpret):
    """autograd through ``MhaFunction`` (on the CPU: the plain forward and
    ``_mha_bwd_torch``) against ``jax.grad`` of the JAX package's XLA path
    and of its Pallas kernel pair under the interpreter, rate 0, 1e-5."""
    import jax

    q, k, v, bias, g = _bwd_inputs(3, s, 4, 8, seed=s)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_mha(q, k, v, jnp.asarray(bias),
                                        impl=jax_impl) * jnp.asarray(g)),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    got = _port_grads(q, k, v, bias, g,
                      lambda *a: port.MhaFunction.apply(*a, 0.0, 0))
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, np.asarray(ref), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 3), (0.5, 1 << 40)])
def test_mha_bwd_formula_matches_autograd(rate, seed):
    """``_mha_bwd_torch`` (the explicit formula K2 mirrors) equals autograd
    through ``_mha_torch`` with the same seed, so the same mask: 1e-5."""
    q, k, v, bias, g = _bwd_inputs(2, 19, 3, 8, seed=7)
    got = port._mha_bwd_torch(*(torch.from_numpy(a) for a in (q, k, v, bias,
                                                              g)),
                              rate, seed)
    want = _port_grads(q, k, v, bias, g,
                       lambda *a: port._mha_torch(*a, rate, seed))
    for x, ref in zip(got, want):
        assert x.is_contiguous()
        np.testing.assert_allclose(x.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_mha_function_gradcheck_float64():
    """``torch.autograd.gradcheck`` of the plain forward paired with
    ``_mha_bwd_torch``, in float64 (the plain versions keep float64) at
    rate 0.2 with padded keys."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.tensor(rng.randn(2, 6, 2, 8), dtype=torch.float64,
                            requires_grad=True) for _ in range(3))
    bias = torch.zeros(2, 6, dtype=torch.float64)
    bias[1, 4:] = -10000.0
    assert torch.autograd.gradcheck(
        lambda q, k, v: _PlainPair.apply(q, k, v, bias, 0.2, 9), (q, k, v),
        eps=1e-6, atol=1e-6)


class _PlainPair(torch.autograd.Function):
    """``MhaFunction``'s pairing (forward, then the explicit backward from
    q, k, v, bias and the seed) on the plain versions, which take float64
    where the kernel wrappers take fp32/bf16 only."""

    @staticmethod
    def forward(ctx, q, k, v, bias, rate, seed):
        ctx.save_for_backward(q, k, v, bias)
        ctx.rate, ctx.seed = rate, seed
        return port._mha_torch(q, k, v, bias, rate, seed)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        return (*port._mha_bwd_torch(q, k, v, bias, g, ctx.rate, ctx.seed),
                None, None, None)


@pytest.mark.parametrize("s", [13, 104])
def test_mha_lse_matches_jax_logsumexp(s):
    """``_mha_torch(return_lse=True)``'s LSE (what the bf16 K1 writes and K2
    reads) against ``jax.nn.logsumexp`` of the JAX package's scaled, biased
    scores (``_mha_xla``'s), rows 0 and 1 all padding: 1e-5 + 2**-20 |ref|
    (all-padding rows sit near -10000, where the fp32 grid is 2**-10 and
    two correct sums may land one step apart); ``mha_fwd(lse=...)`` fills
    the buffer with the same values on the CPU."""
    import jax

    q, k, v, bias = _inputs(4, s, 3, 8, seed=s)
    scores = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), jnp.asarray(k),
                        preferred_element_type=jnp.float32)
    scores = scores / jnp.sqrt(jnp.float32(8)) + jnp.asarray(bias)[:, None,
                                                                   None, :]
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    out, lse = port._mha_torch(tq, tk, tv, tb, return_lse=True)
    assert lse.shape == (4, 3, s) and lse.dtype == torch.float32
    assert np.isfinite(lse.numpy()).all()
    assert (np.abs(lse.numpy() - want) <= 1e-5 + 2.0**-20 * np.abs(want)).all()
    buf = torch.empty(4, 3, s)
    torch.testing.assert_close(port.mha_fwd(tq, tk, tv, tb, lse=buf), out,
                               atol=0, rtol=0)
    torch.testing.assert_close(buf, lse, atol=0, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("s", [13, 70, 130])
def test_mha_bwd_lse_formula_matches_reference(s, rate):
    """``_mha_bwd_lse_torch`` (the one-pass formula of the bf16 K2: P from
    the forward's LSE, Di = rowsum(g * out)) equals ``_mha_bwd_torch`` (the
    JAX kernel's formula) in float64 within 1e-12, with an all-padding row
    (zero query) and padded keys, at rates 0 and 0.1 (same mask); the CPU
    wrapper takes it when given out and lse."""
    q, k, v, bias, g = (torch.from_numpy(a.astype(np.float64))
                        for a in _bwd_inputs(3, s, 2, 8, seed=s))
    out, lse = port._mha_torch(q, k, v, bias, rate, 5, return_lse=True)
    got = port._mha_bwd_lse_torch(q, k, v, bias, g, out, lse, rate, 5)
    want = port._mha_bwd_torch(q, k, v, bias, g, rate, 5)
    for x, ref in zip(got, want):
        assert x.dtype == torch.float64 and x.is_contiguous()
        assert (x - ref).abs().max().item() <= 1e-12
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    b32 = bias.float()
    out32, lse32 = port._mha_torch(q32, k32, v32, b32, rate, 5,
                                   return_lse=True)
    for x, ref in zip(port.mha_bwd(q32, k32, v32, b32, g32, rate, 5,
                                   out=out32, lse=lse32),
                      port._mha_bwd_lse_torch(q32, k32, v32, b32, g32,
                                              out32, lse32, rate, 5)):
        torch.testing.assert_close(x, ref, atol=0, rtol=0)


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)
                            ).bfloat16().float().numpy()


def _tensor_core_products(a, b):
    """a @ b as the tensor cores form it from bf16 operands: exact products,
    fp32 sums of at most 64 terms, the partials added in fp32."""
    out = np.zeros(a.shape[:-1] + (b.shape[-1],), np.float32)
    for k0 in range(0, a.shape[-1], 64):
        out += np.matmul(a[..., k0:k0 + 64], b[..., k0:k0 + 64, :])
    return out


def test_hi_lo_split_sits_inside_the_bf16_tolerance():
    """The numerics decision of the bf16 K2, made before the card: P_d and
    dS are fp32, and the tensor cores take bf16, so each goes in as
    hi = bf16(x) plus lo = bf16(x - hi), two products. Emulated in numpy at
    (B, S, H, D) = (8, 104, 2, 64) with bf16 q, k, v, g and padded keys,
    dV = P^T g, dQ = dS K and dK = dS^T Q through the split stay >= 10x
    inside K2's tolerance 1e-3 + 2**-8 |ref| of the exact float64 product;
    one bf16 rounding of P and dS (FlashAttention's way) would not fit in
    it at all."""
    b, s, h, d = 8, 104, 2, 64
    rng = np.random.RandomState(0)
    q, k, v, g = (_bf16(rng.randn(b, h, s, d)) for _ in range(4))
    lens = rng.randint(1, s + 1, size=b)
    bias = ((np.arange(s)[None, :] >= lens[:, None]) * -10000.0
            ).astype(np.float32)
    scores = np.einsum("bhqd,bhkd->bhqk", q, k) / np.float32(8.0) \
        + bias[:, None, None, :]
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    dp = np.einsum("bhqd,bhkd->bhqk", g, v).astype(np.float32)
    ds = (p * (dp - (dp * p).sum(-1, keepdims=True)) / 8.0).astype(np.float32)
    for a, rhs in ((p.swapaxes(-1, -2), g), (ds, k), (ds.swapaxes(-1, -2), q)):
        exact = np.matmul(a.astype(np.float64), rhs.astype(np.float64))
        tol = 1e-3 + 2.0**-8 * np.abs(exact)
        hi = _bf16(a)
        split = (_tensor_core_products(hi, rhs)
                 + _tensor_core_products(_bf16(a - hi), rhs))
        assert (np.abs(split - exact) / tol).max() <= 0.1
        assert (np.abs(_tensor_core_products(hi, rhs) - exact) / tol
                ).max() > 1.0


def test_mha_function_bf16_saves_out_and_lse():
    """In bf16 ``MhaFunction`` saves the output, its bf16 remainder and the
    fp32 LSE besides q, k, v and bias, and its backward is
    ``_mha_bwd_lse_torch`` on them (out + out_lo, the fp32 output); fp32
    saves the output, the LSE and the LSE's fp32 remainder in place of
    out_lo (tests/test_torch_attention_fp32.py holds its gradients).
    The bf16 gradients agree with the JAX kernel's formula
    (``_mha_bwd_torch``) in fp32 on the same bf16 inputs to K2's tolerance
    2**-8 |ref| + 1e-3 (one rounding of each gradient), since Di comes from
    the fp32 output; from the bf16 output alone they would not."""
    q, k, v, bias, g = _bwd_inputs(3, 24, 4, 8, seed=2)
    tq, tk, tv, tg = (torch.from_numpy(a).bfloat16() for a in (q, k, v, g))
    tb = torch.from_numpy(bias)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = port.MhaFunction.apply(*leaves, tb, 0.1, 7)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 7 and saved[5].dtype == torch.float32
    assert saved[5].shape == (3, 4, 24) and saved[6].dtype == torch.bfloat16
    out.backward(tg)
    full = saved[4].float() + saved[6].float()  # the fp32 output to 2**-16
    torch.testing.assert_close(full, port._mha_torch(
        *(t.float() for t in (tq, tk, tv)), tb, 0.1, 7),
        atol=2.0**-15 * full.abs().max().item(), rtol=0)
    want = port._mha_bwd_lse_torch(tq, tk, tv, tb, tg, full, saved[5], 0.1, 7)
    ref = port._mha_bwd_torch(*(t.float() for t in (tq, tk, tv)), tb,
                              tg.float(), 0.1, 7)
    for leaf, w, r in zip(leaves, want, ref):
        torch.testing.assert_close(leaf.grad, w, atol=0, rtol=0)
        assert ((leaf.grad.float() - r).abs() <= 2.0**-8 * r.abs() + 1e-3
                ).all()
    f32 = port.MhaFunction.apply(*(torch.from_numpy(a).requires_grad_()
                                   for a in (q, k, v)), tb, 0.1, 7)
    saved32 = f32.grad_fn.saved_tensors
    assert len(saved32) == 7 and saved32[6].dtype == torch.float32
    assert saved32[6].shape == (3, 4, 24)


@pytest.mark.parametrize("heads_total,h,head0", [(4, 2, 0), (4, 2, 2),
                                                 (12, 6, 6), (12, 3, 9)])
def test_head_offset_mask_is_the_head_block(heads_total, h, head0):
    """The mask of heads head0... of ``heads_total`` at a row base is, bit
    for bit, that head block of the whole call's mask at the same base;
    and ``mha_fwd`` / ``mha_bwd`` (the CPU wrappers, which check the
    heads) at that offset give that block of the whole call."""
    b, s, d, rate, seed, base = 3, 10, 8, 0.3, 5, 7 * 4 * 10
    rng = np.random.RandomState(heads_total + head0)
    qf, kf, vf, gf = (torch.from_numpy(rng.randn(b, s, heads_total, d)
                                       .astype(np.float32))
                      for _ in range(4))
    bias = torch.zeros(b, s)
    whole = port._probs_mask(qf, rate, seed, base)
    blk = (slice(None), slice(None), slice(head0, head0 + h))
    q, k, v, g = (x[blk] for x in (qf, kf, vf, gf))
    hk = dict(row_base=base, heads_total=heads_total, head0=head0)
    assert torch.equal(port._probs_mask(q, rate, seed, **hk),
                       whole[:, head0:head0 + h])
    out = port.mha_fwd(q, k, v, bias, rate, seed, **hk)
    want = port._mha_torch(qf, kf, vf, bias, rate, seed, row_base=base)
    torch.testing.assert_close(out, want[blk], rtol=0, atol=1e-6)
    for got, ref in zip(port.mha_bwd(q, k, v, bias, g, rate, seed, **hk),
                        port._mha_bwd_torch(qf, kf, vf, bias, gf, rate,
                                            seed, row_base=base)):
        torch.testing.assert_close(got, ref[blk], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="do not lie in"):
        port.mha_fwd(q, k, v, bias, rate, seed, row_base=base,
                     heads_total=heads_total, head0=heads_total - h + 1)
