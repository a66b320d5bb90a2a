"""The numerics of the fp32 attention kernels on the CPU, against the JAX
package's ``multi_head_attention``.

The fp32 K1 and K2 (``csrc/mha_fwd.cu`` ``mha_fwd_tf32_kernel``,
``csrc/mha_bwd.cu`` ``mha_bwd_tf32_kernel``) run their products on the TF32
tensor cores, each operand split as x = hi + lo (hi = tf32(x), lo =
tf32(x - hi)) and each product taken in three passes, lo hi + hi lo + hi hi,
partials of at most 64 products added in fp32. ``_mha_tf32_torch`` and
``_mha_bwd_tf32_torch`` repeat that order of operations in torch (TF32
rounding on the bits, as the kernels round), so these tests hold the split
itself to the fp32 contract: the forward within 1e-5 of the JAX package's
XLA path and of its Pallas kernel under the interpreter, the gradients
within 1e-4 of ``jax.grad`` of the Pallas kernel pair. A single TF32 pass
misses 1e-5 by far at the same sizes, so the tests have teeth. The CUDA
kernels are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Rows whose keys are all padding get the bound that
tests/test_torch_attention.py explains (their scores sit on the fp32 grid
at -10000).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uniter_tpu.ops.attention import multi_head_attention as jax_mha
from uniter_tpu_torch.ops import attention as port

torch.set_num_threads(2)

FWD_TOL = 1e-5
BWD_TOL = 1e-4
SIZES = [(13, 64), (13, 8), (104, 64), (104, 8)]  # (S, D)


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


def _bwd_inputs(b, s, h, d, seed=0):
    """As ``_inputs`` plus an output gradient g, with only row 0 all padding
    (zero query: its scores are exactly -10000); row 1 half padded."""
    q, k, v, bias = _inputs(b, s, h, d, seed)
    bias[1] = 0.0
    bias[1, s // 2:] = -10000.0
    g = np.random.RandomState(seed + 1).randn(b, s, h, d).astype(np.float32)
    return q, k, v, bias, g


def _fwd_excess(out, ref, v, tol):
    """The worst of |out - ref| - tol over every row but row 1, and of row
    1 (all padding, random query) against the fp32 grid bound."""
    keep = [i for i in range(out.shape[0]) if i != 1]
    rest = (np.abs(out[keep] - ref[keep]) - tol * (1 + np.abs(ref[keep]))
            ).max()
    grid = np.abs(out[1] - ref[1]).max() - (2.0**-9 * np.abs(v[1]).max()
                                            + tol)
    return max(rest, grid)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("UNITER_PALLAS_INTERPRET", "1")


def _twin(q, k, v, bias, passes=3, **kw):
    return port._mha_tf32_torch(*(torch.from_numpy(a) for a in (q, k, v,
                                                                bias)),
                                passes=passes, **kw)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("s,d", SIZES)
def test_tf32_split_forward_matches_jax(jax_impl, s, d, pallas_interpret):
    """The three-pass twin of the fp32 K1 against the JAX package's XLA path
    and its Pallas kernel (interpreted): atol = rtol = 1e-5; its LSE plus
    remainder against ``jax.nn.logsumexp`` of the scaled, biased scores to
    1e-5, and the remainder smaller than half an fp32 step of the LSE."""
    q, k, v, bias = _inputs(3, s, 2, d, seed=s + d)
    ref = np.asarray(jax_mha(*(jnp.asarray(a) for a in (q, k, v, bias)),
                             impl=jax_impl))
    out, lse, lse_lo = _twin(q, k, v, bias, return_lse=True)
    assert _fwd_excess(out.numpy(), ref, v, FWD_TOL) <= 0
    scores = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), jnp.asarray(k),
                        preferred_element_type=jnp.float32)
    scores = scores / jnp.sqrt(jnp.float32(d)) \
        + jnp.asarray(bias)[:, None, None, :]
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)).astype(np.float64)
    full = lse.double().numpy() + lse_lo.double().numpy()
    assert (np.abs(full - want) <= 1e-5 + 2.0**-20 * np.abs(want)).all()
    assert (np.abs(lse_lo.numpy()) <= 2.0**-24 * np.abs(lse.numpy())).all()


@pytest.mark.parametrize("s,d", SIZES)
def test_one_tf32_pass_misses_the_fp32_tolerance(s, d):
    """The control: at the same sizes and inputs, one TF32 pass (hi hi, 10
    mantissa bits an operand) lands far outside 1e-5 of the JAX package's
    result, where the three passes land inside it."""
    q, k, v, bias = _inputs(3, s, 2, d, seed=s + d)
    ref = np.asarray(jax_mha(*(jnp.asarray(a) for a in (q, k, v, bias)),
                             impl="xla"))
    assert _fwd_excess(_twin(q, k, v, bias).numpy(), ref, v, FWD_TOL) <= 0
    one = _twin(q, k, v, bias, passes=1).numpy()
    assert _fwd_excess(one, ref, v, FWD_TOL) > 10 * FWD_TOL


@pytest.mark.parametrize("s,d", SIZES)
def test_tf32_split_backward_matches_jax_grad(s, d, pallas_interpret):
    """The three-pass twin of the fp32 K2, from the forward twin's output,
    LSE and LSE remainder, against ``jax.grad`` of the JAX package's Pallas
    kernel pair (interpreted), rate 0: within 1e-4; one TF32 pass misses
    it."""
    q, k, v, bias, g = _bwd_inputs(3, s, 2, d, seed=s + d)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_mha(q, k, v, jnp.asarray(bias),
                                        impl="pallas") * jnp.asarray(g)),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv, tb, tg = (torch.from_numpy(a) for a in (q, k, v, bias, g))
    for passes, ok in ((3, True), (1, False)):
        out, lse, lo = port._mha_tf32_torch(tq, tk, tv, tb, passes=passes,
                                            return_lse=True)
        got = port._mha_bwd_tf32_torch(tq, tk, tv, tb, tg, out, lse, lo,
                                       passes=passes)
        err = max(np.abs(x.numpy() - np.asarray(w)).max()
                  for x, w in zip(got, want))
        assert (err <= BWD_TOL) == ok, (passes, err)
        for x in got:
            assert x.dtype == torch.float32 and x.is_contiguous()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mha_function_fp32_saves_out_and_lse(rate, pallas_interpret):
    """In fp32 ``MhaFunction`` saves the output, the fp32 LSE and its
    remainder besides q, k, v and bias, as the one-pass fp32 K2 reads them;
    on the CPU its backward is ``_mha_bwd_lse_torch`` on them. At rate 0 its
    gradients equal ``jax.grad`` of the JAX package's Pallas kernel within
    1e-4; at rate 0.1 they equal the JAX kernel's formula
    ``_mha_bwd_torch`` on the same Philox mask within 1e-5."""
    q, k, v, bias, g = _bwd_inputs(3, 24, 4, 8, seed=5)
    tb, tg = torch.from_numpy(bias), torch.from_numpy(g)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = port.MhaFunction.apply(*leaves, tb, rate, 7)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 7
    assert saved[4] is out or torch.equal(saved[4], out)
    for t in saved[5:]:
        assert t.dtype == torch.float32 and t.shape == (3, 4, 24)
    ref_out, ref_lse = port._mha_torch(*leaves, tb, rate, 7, return_lse=True)
    torch.testing.assert_close(saved[5], ref_lse, atol=0, rtol=0)
    out.backward(tg)
    if rate == 0.0:
        want = jax.grad(
            lambda q, k, v: jnp.sum(jax_mha(q, k, v, jnp.asarray(bias),
                                            impl="pallas") * jnp.asarray(g)),
            argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
        tol = BWD_TOL
    else:
        want = port._mha_bwd_torch(*(t.detach() for t in leaves), tb, tg,
                                   rate, 7)
        tol = FWD_TOL
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=tol, rtol=0)


@pytest.mark.parametrize("bh,s,want", [(1152, 104, 1), (96, 512, 4),
                                       (576, 224, 1), (4, 512, 8),
                                       (16, 70, 2), (36, 13, 1), (40, 384, 6)])
def test_k2_key_groups_fill_the_card(bh, s, want):
    """The fp32 K2 runs one block per (b, h) and key-tile group: the fewest
    equal groups that let B*H*groups fill both block slots of each of the
    H100's 132 SMs, at most one a key tile; its shared memory leaves room
    for two blocks an SM at D = 64 up to S = 512."""
    assert port._key_groups(bh, s, 132) == want
    for seq in (104, 512):
        assert 2 * (port._bwd_smem(seq, 64, torch.float32) + 1024) \
            <= 228 * 1024
