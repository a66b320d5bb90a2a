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
    elif bad == "seq":
        q, k, v = (t.repeat(1, 33, 1, 1) for t in (q, k, v))
        bias = bias.repeat(1, 33)
    elif bad == "bias_shape":
        bias = bias[:, :8]
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        port.mha_fwd(q, k, v, bias)


def test_attention_dropout_waits_for_training_slice():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 8))
    with pytest.raises(NotImplementedError):
        port.multi_head_attention(q, k, v, bias, dropout_rate=0.1,
                                  deterministic=False)
    # deterministic calls ignore the rate
    port.multi_head_attention(q, k, v, bias, dropout_rate=0.1)

