"""Multi-head self-attention: the plain torch versions and the K1/K2 kernels.

Semantics follow the reference's BertSelfAttention (model/layer.py:75-101):
scores = QK^T / sqrt(head_dim) + additive_bias; probs = softmax(scores);
probs = dropout(probs); out = probs @ V, with the ``(1-mask) * -10000``
padding bias of model/model.py:342-345. The public layout is the JAX
package's: q/k/v ``[B, S, H, D]``, bias ``[B, S_k]`` fp32, result
``[B, S, H, D]``.

``_mha_torch`` is the counterpart of ``uniter_tpu/ops/attention.py``
``_mha_xla``, ``_mha_bwd_torch`` the explicit formula of
``_mha_bwd_kernel``. ``mha_fwd`` and ``mha_bwd`` wrap the hand-written CUDA
kernels (``csrc/mha_fwd.cu``, K1, and ``csrc/mha_bwd.cu``, K2): a CUDA
tensor always goes to the kernel, a CPU tensor to the plain version.
``MhaFunction`` pairs them as the JAX package's custom VJP
(``_mha_pallas``, :335-351) does, saving only q, k, v, bias and the seed.

Dropout on P draws its mask from ``ops.dropout.keep_mask`` over the
``[B, H, S, S]`` probabilities (row ``(b*H + h)*S + q``, column ``k``);
the kernels compute the same bits from the same seed.
"""

from __future__ import annotations

import math

import torch

from uniter_tpu_torch.ops import _kernels
from uniter_tpu_torch.ops.dropout import keep_mask, threshold

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SEQ = 512
MAX_HEAD_DIM = 128


def _f32(t):
    """fp32 arithmetic for fp32/bf16 inputs; float64 stays float64 (for
    gradient checks of the plain versions)."""
    return t if t.dtype == torch.float64 else t.float()


def _probs_mask(q, rate, seed):
    b, s, h, _ = q.shape
    return keep_mask(seed, 0, (b, h, s, s), rate, q.device)


def _mha_torch(q, k, v, bias, rate: float = 0.0, seed: int = 0):
    """q, k, v: [B, S, H, D]; bias: [B, S_k] additive fp32.

    Scores in fp32 (q and k upcast, as ``preferred_element_type`` does in
    JAX), scaled before the bias is added; at ``rate`` > 0 the normalised
    probabilities are masked by the Philox bits of ``seed`` and rescaled by
    1/(1-rate); probabilities cast to ``v.dtype`` before P.V."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", _f32(q), _f32(k))
    scores = scores * scale + _f32(bias)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    if rate > 0.0:
        probs = torch.where(_probs_mask(q, rate, seed), probs / (1.0 - rate),
                            torch.zeros((), device=probs.device))
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _mha_bwd_torch(q, k, v, bias, g, rate: float = 0.0, seed: int = 0):
    """dq, dk, dv of ``_mha_torch`` by the formula of ``_mha_bwd_kernel``
    (not autograd): recompute P, replay the mask, dV = P_d^T g,
    dP = g V^T masked and rescaled, dS = P * (dP - rowsum(dP * P)) / sqrt(D),
    dQ = dS K, dK = dS^T Q; fp32 arithmetic, results in q's dtype,
    contiguous [B, S, H, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (_f32(t) for t in (q, k, v, g))
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p = torch.softmax(scores * scale + _f32(bias)[:, None, None, :], dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    pd = p
    if rate > 0.0:
        keep = _probs_mask(q, rate, seed)
        zero = torch.zeros((), device=p.device)
        pd = torch.where(keep, p / (1.0 - rate), zero)
        dp = torch.where(keep, dp / (1.0 - rate), zero)
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, gf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return tuple(t.to(q.dtype).contiguous() for t in (dq, dk, dv))


def _check(q, k, v, bias, name="mha_fwd"):
    if not (q.device == k.device == v.device == bias.device):
        raise ValueError("q, k, v and bias must lie on one device")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name} takes float32 or bfloat16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one [B, S, H, D] shape, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    b, s, h, d = q.shape
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if s > MAX_SEQ or s < 1:
        raise ValueError(f"sequence length must be 1..{MAX_SEQ}, got {s}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the launch grid")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v need a contiguous head dim (stride 1)")
    if tuple(bias.shape) != (b, s) or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous [{b}, {s}] tensor, got "
                         f"{tuple(bias.shape)}")


def _check_dropout(rate, seed):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    if not 0 <= int(seed) < 2**63:
        raise ValueError(f"seed must be a non-negative 64-bit int, got {seed}")


def mha_fwd(q, k, v, bias, rate: float = 0.0, seed: int = 0):
    """K1: dropout(softmax(QK^T/sqrt(D) + bias)) V through the CUDA kernel.

    Takes the layout of ``multi_head_attention``. A CPU input takes the
    plain version; a CUDA input launches the kernel or raises — there is no
    fallback. ``mha_fwd.launches`` counts the kernel's launches. Rate 0
    draws no bits."""
    _check(q, k, v, bias)
    _check_dropout(rate, seed)
    if q.device.type == "cpu":
        return _mha_torch(q, k, v, bias, rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"mha_fwd runs on cuda or cpu, not {q.device}")
    b, s, h, d = q.shape
    fn = _kernels.load("mha_fwd").uniter_mha_fwd
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    thr = threshold(rate) if rate > 0.0 else 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), b, s, h, d, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], 1.0 / math.sqrt(d), thr,
                1.0 / (1.0 - rate), int(seed), _DTYPE_CODE[q.dtype], stream)
    if rc:
        raise RuntimeError(f"mha_fwd kernel launch failed: cudaError_t {rc} "
                           f"at q{tuple(q.shape)} {q.dtype}")
    mha_fwd.launches += 1
    return out


mha_fwd.launches = 0


def mha_bwd(q, k, v, bias, g, rate: float = 0.0, seed: int = 0):
    """K2: dq, dk, dv of ``mha_fwd`` (same rate and seed) for the output
    gradient ``g`` [B, S, H, D], through the CUDA kernel; a CPU input takes
    ``_mha_bwd_torch``. Results are contiguous [B, S, H, D] in q's dtype.
    ``mha_bwd.launches`` counts the kernel's launches (one per call; a call
    runs its two passes back to back on the stream)."""
    _check(q, k, v, bias, "mha_bwd")
    _check_dropout(rate, seed)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g must match q: {tuple(g.shape)} {g.dtype} "
                         f"{g.device} vs {tuple(q.shape)} {q.dtype}")
    if g.stride(-1) != 1:
        g = g.contiguous()
    if q.device.type == "cpu":
        return _mha_bwd_torch(q, k, v, bias, g, rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"mha_bwd runs on cuda or cpu, not {q.device}")
    b, s, h, d = q.shape
    fn = _kernels.load("mha_bwd").uniter_mha_bwd
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    stats = torch.empty((3, b, h, s), dtype=torch.float32, device=q.device)
    thr = threshold(rate) if rate > 0.0 else 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                bias.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                stats.data_ptr(), b, s, h, d, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
                1.0 / math.sqrt(d), thr, 1.0 / (1.0 - rate), int(seed),
                _DTYPE_CODE[q.dtype], stream)
    if rc:
        raise RuntimeError(f"mha_bwd kernel launch failed: cudaError_t {rc} "
                           f"at q{tuple(q.shape)} {q.dtype}")
    mha_bwd.launches += 1
    return dq, dk, dv


mha_bwd.launches = 0


class MhaFunction(torch.autograd.Function):
    """K1 forward, K2 backward. Saves q, k, v, bias and the seed, as the
    JAX package's ``_mha_pallas_fwd`` saves them; the bias gets no gradient
    (it comes from ``attn_mask``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, rate, seed):
        ctx.save_for_backward(q, k, v, bias)
        ctx.rate, ctx.seed = rate, seed
        return mha_fwd(q, k, v, bias, rate, seed)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = mha_bwd(q, k, v, bias, g, ctx.rate, ctx.seed)
        return dq, dk, dv, None, None, None


def multi_head_attention(q, k, v, bias, *, impl: str = "xla",
                         dropout_rate: float = 0.0,
                         deterministic: bool = True,
                         seed: int = None):
    """Fused MHA. q, k, v: [B, S, H, D]; bias: [B, S] additive (0 / -10000).

    ``impl="cuda"`` takes the kernels (``MhaFunction``: K1 forward, K2
    backward), ``"xla"`` the plain version under autograd. Dropout on P is
    live when ``deterministic`` is False and the rate positive; it then
    needs the call's ``seed`` (``ops.dropout.draw_seed``). Returns
    [B, S, H, D]."""
    rate = 0.0 if deterministic else float(dropout_rate)
    if rate > 0.0 and seed is None:
        raise ValueError("live attention dropout needs a seed")
    seed = int(seed or 0) if rate > 0.0 else 0
    if impl == "cuda":
        return MhaFunction.apply(q, k, v, bias.float(), rate, seed)
    if impl == "xla":
        return _mha_torch(q, k, v, bias, rate, seed)
    raise ValueError(f"unknown attention impl {impl!r}")
