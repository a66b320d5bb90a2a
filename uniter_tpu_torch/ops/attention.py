"""Multi-head self-attention: the plain torch versions and the K1/K2 kernels.

Semantics follow the reference's BertSelfAttention (model/layer.py:75-101):
scores = QK^T / sqrt(head_dim) + additive_bias; probs = softmax(scores);
probs = dropout(probs); out = probs @ V, with the ``(1-mask) * -10000``
padding bias of model/model.py:342-345. The public layout is the JAX
package's: q/k/v ``[B, S, H, D]``, bias ``[B, S_k]`` fp32, result
``[B, S, H, D]``.

``_mha_torch`` is the counterpart of ``uniter_tpu/ops/attention.py``
``_mha_xla`` (with ``return_lse`` it also gives the row log-sum-exp of the
scaled, biased scores), ``_mha_bwd_torch`` the explicit formula of
``_mha_bwd_kernel`` and ``_mha_bwd_lse_torch`` the same gradients from the
forward's output and LSE (one pass: no softmax over the keys first).
``mha_fwd`` and ``mha_bwd`` wrap the hand-written CUDA kernels
(``csrc/mha_fwd.cu``, K1, and ``csrc/mha_bwd.cu``, K2), picked by dtype:
bf16 runs the tensor-core kernels (K1 writes the LSE and the output's bf16
remainder, K2 reads them and the output), fp32 the SIMT ones (K2 recomputes
the row statistics). A CUDA
tensor always goes to a kernel, a CPU tensor to the plain version.
``MhaFunction`` pairs them as the JAX package's custom VJP
(``_mha_pallas``, :335-351) does. In bf16 it saves the output, its bf16
remainder and the [B, H, S] fp32 LSE besides q, k, v, bias and the seed,
which the JAX VJP does not: the LSE is what makes K2 one pass, and the
output to fp32 precision gives Di = rowsum(g * out) as exactly as the JAX
kernel's rowsum(dP * P). The output's storage costs nothing (the output
projection saves it as its input); the remainder is 2 bytes an element.

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
SMEM_LIMIT = 232448  # dynamic shared memory a block may opt into (227 KB)


def _f32(t):
    """fp32 arithmetic for fp32/bf16 inputs; float64 stays float64 (for
    gradient checks of the plain versions)."""
    return t if t.dtype == torch.float64 else t.float()


def _probs_mask(q, rate, seed):
    b, s, h, _ = q.shape
    return keep_mask(seed, 0, (b, h, s, s), rate, q.device)


def _mha_torch(q, k, v, bias, rate: float = 0.0, seed: int = 0,
               return_lse: bool = False):
    """q, k, v: [B, S, H, D]; bias: [B, S_k] additive fp32.

    Scores in fp32 (q and k upcast, as ``preferred_element_type`` does in
    JAX), scaled before the bias is added; at ``rate`` > 0 the normalised
    probabilities are masked by the Philox bits of ``seed`` and rescaled by
    1/(1-rate); probabilities cast to ``v.dtype`` before P.V. With
    ``return_lse`` returns (out, lse), lse the [B, H, S] log-sum-exp of the
    scaled, biased scores (fp32; float64 for float64 inputs)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", _f32(q), _f32(k))
    scores = scores * scale + _f32(bias)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    if rate > 0.0:
        probs = torch.where(_probs_mask(q, rate, seed), probs / (1.0 - rate),
                            torch.zeros((), device=probs.device))
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def _mha_bwd_torch(q, k, v, bias, g, rate: float = 0.0, seed: int = 0):
    """dq, dk, dv of ``_mha_torch`` by the formula of ``_mha_bwd_kernel``
    (not autograd): recompute P, replay the mask, dV = P_d^T g,
    dP = g V^T masked and rescaled, dS = P * (dP - rowsum(dP * P)) / sqrt(D),
    dQ = dS K, dK = dS^T Q; fp32 arithmetic, results in q's dtype,
    contiguous [B, S, H, D]."""
    scores = torch.einsum("bqhd,bkhd->bhqk", _f32(q), _f32(k))
    p = torch.softmax(scores * (1.0 / math.sqrt(q.shape[-1]))
                      + _f32(bias)[:, None, None, :], dim=-1)
    return _grads_from_probs(q, k, g, v, p, rate, seed)


def _mha_bwd_lse_torch(q, k, v, bias, g, out, lse, rate: float = 0.0,
                       seed: int = 0):
    """The gradients of ``_mha_bwd_torch`` from the forward's ``out``
    [B, S, H, D] and ``lse`` [B, H, S], as the bf16 K2 computes them:
    P = exp(s - lse) with no pass over the keys first, and
    Di = rowsum(g * out), which equals rowsum(dPm * P) (dropout included,
    since out = P_d V). fp32 arithmetic, results in q's dtype, contiguous."""
    scores = torch.einsum("bqhd,bkhd->bhqk", _f32(q), _f32(k))
    p = torch.exp(scores * (1.0 / math.sqrt(q.shape[-1]))
                  + _f32(bias)[:, None, None, :] - _f32(lse)[..., None])
    di = (_f32(g) * _f32(out)).sum(-1).transpose(1, 2)  # [B, H, S]
    return _grads_from_probs(q, k, g, v, p, rate, seed, di)


def _grads_from_probs(q, k, g, v, p, rate, seed, di=None):
    """dq, dk, dv from the probabilities P [B, H, S, S]: the mask of
    ``seed`` replayed, dV = P_d^T g, dP = g V^T masked and rescaled,
    dS = P (dP - Di) / sqrt(D) with Di = rowsum(dP * P) unless given,
    dQ = dS K, dK = dS^T Q."""
    qf, kf, vf, gf = (_f32(t) for t in (q, k, v, g))
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    pd = p
    if rate > 0.0:
        keep = _probs_mask(q, rate, seed)
        zero = torch.zeros((), device=p.device)
        pd = torch.where(keep, p / (1.0 - rate), zero)
        dp = torch.where(keep, dp / (1.0 - rate), zero)
    if di is None:
        di = (dp * p).sum(-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, gf)
    ds = p * (dp - di[..., None]) * (1.0 / math.sqrt(q.shape[-1]))
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


def _dim_pad(d):
    """The head dim the bf16 kernels pad their tiles to (zeros)."""
    return next(p for p in (16, 32, 64, 128) if d <= p)


def _bwd_tc_smem(s, d, dq_shared=True):
    """Dynamic shared memory of the bf16 K2 block (``tc_smem`` in
    csrc/mha_bwd.cu): K, V and double-buffered Q, g tiles, dS^T hi and lo,
    LSE, Di, the tile's dropout bits and, when it fits, dQ in fp32."""
    dp, s_pad = _dim_pad(d), -(-s // 64) * 64
    return (6 * 64 * (dp + 8) * 2 + 2 * 64 * 72 * 2 + 2 * s_pad * 4 + 512
            + (s_pad * (dp + 8) * 4 if dq_shared else 0))


def _tc_aligned(t):
    """The bf16 kernels stage rows by 16-byte cp.async: the base pointer
    and every stride must be a multiple of 8 elements."""
    return not (t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]))


def _check_tc_layout(*ts, names="q/k/v"):
    for t in ts:
        if not _tc_aligned(t):  # no fallback
            raise ValueError(
                f"{names}: the bf16 kernels need 16-byte aligned bases and "
                f"strides that are multiples of 8 elements, got strides "
                f"{t.stride()} at offset {t.storage_offset()}")


def _check_lse(lse, q):
    b, s, h, _ = q.shape
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 [{b}, {h}, {s}] "
                         f"tensor on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype} {lse.device}")


def _check_like(t, q, name, dtype=None):
    if t.shape != q.shape or t.dtype != (dtype or q.dtype) or \
            t.device != q.device:
        raise ValueError(f"{name} must be a {dtype or q.dtype} "
                         f"{tuple(q.shape)} tensor on {q.device}, got "
                         f"{tuple(t.shape)} {t.dtype} {t.device}")


def mha_fwd(q, k, v, bias, rate: float = 0.0, seed: int = 0, lse=None,
            out_lo=None):
    """K1: dropout(softmax(QK^T/sqrt(D) + bias)) V through the CUDA kernel.

    Takes the layout of ``multi_head_attention``. bf16 runs the tensor-core
    kernel (q/k/v 16-byte aligned with strides in multiples of 8), which
    also fills ``lse`` (a float32 [B, H, S] buffer: the row log-sum-exp)
    and ``out_lo`` (a contiguous bf16 [B, S, H, D] buffer: the output's
    remainder, out + out_lo = the fp32 output to ~2**-16) when given; fp32
    runs the SIMT kernel, which writes neither. A CPU input takes the plain
    version; a CUDA input launches a kernel or raises — there is no
    fallback. ``mha_fwd.launches`` counts the launches. Rate 0 draws no
    bits."""
    _check(q, k, v, bias)
    _check_dropout(rate, seed)
    if lse is not None:
        _check_lse(lse, q)
    if out_lo is not None:
        _check_like(out_lo, q, "out_lo", torch.bfloat16)
    if q.device.type == "cpu":
        if lse is None and out_lo is None:
            return _mha_torch(q, k, v, bias, rate, seed)
        out, plain_lse = _mha_torch(q, k, v, bias, rate, seed,
                                    return_lse=True)
        if lse is not None:
            lse.copy_(plain_lse)
        if out_lo is not None:
            full = _mha_torch(q.float(), k.float(), v.float(), bias, rate,
                              seed)
            out_lo.copy_(full - out.float())
        return out
    if q.device.type != "cuda":
        raise ValueError(f"mha_fwd runs on cuda or cpu, not {q.device}")
    if q.dtype == torch.bfloat16:
        _check_tc_layout(q, k, v)
        if out_lo is not None and not out_lo.is_contiguous():
            raise ValueError("out_lo must be contiguous")
    elif lse is not None or out_lo is not None:
        raise ValueError("the fp32 kernel writes no LSE or remainder")
    b, s, h, d = q.shape
    fn = _kernels.load("mha_fwd").uniter_mha_fwd
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    thr = threshold(rate) if rate > 0.0 else 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), _ptr(out_lo), _ptr(lse), b, s, h, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                1.0 / math.sqrt(d), thr, 1.0 / (1.0 - rate), int(seed),
                _DTYPE_CODE[q.dtype], stream)
    if rc:
        raise RuntimeError(f"mha_fwd kernel launch failed: cudaError_t {rc} "
                           f"at q{tuple(q.shape)} {q.dtype}")
    mha_fwd.launches += 1
    return out


mha_fwd.launches = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def mha_bwd(q, k, v, bias, g, rate: float = 0.0, seed: int = 0, out=None,
            lse=None, out_lo=None):
    """K2: dq, dk, dv of ``mha_fwd`` (same rate and seed) for the output
    gradient ``g`` [B, S, H, D]. Results are contiguous [B, S, H, D] in q's
    dtype. bf16 runs the one-pass tensor-core kernel, which needs the
    forward's ``out``, ``lse`` and ``out_lo``; fp32 runs the two SIMT
    passes, which recompute the row statistics and take none of them. A CPU
    input takes ``_mha_bwd_lse_torch`` when given out and lse (the output as
    out + out_lo when out_lo is given), else ``_mha_bwd_torch``.
    ``mha_bwd.launches`` counts the kernel calls (one per call)."""
    _check(q, k, v, bias, "mha_bwd")
    _check_dropout(rate, seed)
    _check_like(g, q, "g")
    if (out is None) != (lse is None):
        raise ValueError("mha_bwd takes the forward's out and lse together")
    if out is not None:
        _check_like(out, q, "out")
        _check_lse(lse, q)
    if out_lo is not None:
        _check_like(out_lo, q, "out_lo", torch.bfloat16)
    if g.stride(-1) != 1:
        g = g.contiguous()
    if q.device.type == "cpu":
        if out is None:
            return _mha_bwd_torch(q, k, v, bias, g, rate, seed)
        if out_lo is not None:
            out = out.float() + out_lo.float()
        return _mha_bwd_lse_torch(q, k, v, bias, g, out, lse, rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"mha_bwd runs on cuda or cpu, not {q.device}")
    b, s, h, d = q.shape
    if q.dtype == torch.bfloat16:
        if out is None or out_lo is None:
            raise ValueError("the bf16 kernel needs the forward's out, lse "
                             "and out_lo")
        _check_tc_layout(q, k, v)
        if not _tc_aligned(g):
            g = g.contiguous()
        out, out_lo = out.contiguous(), out_lo.contiguous()
        _check_tc_layout(out, out_lo, names="out/out_lo")
        scratch = None
        if _bwd_tc_smem(s, d) > SMEM_LIMIT:  # dQ in device memory
            scratch = torch.empty((b * h, -(-s // 64) * 64, _dim_pad(d) + 8),
                                  dtype=torch.float32, device=q.device)
    elif out is not None or out_lo is not None:
        raise ValueError("the fp32 kernel recomputes the row statistics and "
                         "takes no out, lse or out_lo")
    else:
        scratch = torch.empty((3, b, h, s), dtype=torch.float32,
                              device=q.device)
    fn = _kernels.load("mha_bwd").uniter_mha_bwd
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    thr = threshold(rate) if rate > 0.0 else 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                bias.data_ptr(), _ptr(out), _ptr(out_lo), _ptr(lse),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(scratch),
                b, s, h, d, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *g.stride()[:3], 1.0 / math.sqrt(d), thr,
                1.0 / (1.0 - rate), int(seed), _DTYPE_CODE[q.dtype], stream)
    if rc:
        raise RuntimeError(f"mha_bwd kernel launch failed: cudaError_t {rc} "
                           f"at q{tuple(q.shape)} {q.dtype}")
    mha_bwd.launches += 1
    return dq, dk, dv


mha_bwd.launches = 0


class MhaFunction(torch.autograd.Function):
    """K1 forward, K2 backward. fp32 saves q, k, v, bias and the seed, as
    the JAX package's ``_mha_pallas_fwd`` saves them, and K2 recomputes the
    row statistics. bf16 also saves what the one-pass K2 reads: the output,
    its bf16 remainder ``out_lo`` and K1's [B, H, S] fp32 LSE (at B=96,
    S=104, H=12: 15.3 MB and 0.48 MB a layer; the output's own storage is
    the one the output projection saves anyway). The bias gets no gradient
    (it comes from ``attn_mask``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, rate, seed):
        ctx.rate, ctx.seed = rate, seed
        if q.dtype != torch.bfloat16:
            ctx.save_for_backward(q, k, v, bias)
            return mha_fwd(q, k, v, bias, rate, seed)
        b, s, h, _ = q.shape
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        out_lo = torch.empty_like(q, memory_format=torch.contiguous_format)
        out = mha_fwd(q, k, v, bias, rate, seed, lse=lse, out_lo=out_lo)
        ctx.save_for_backward(q, k, v, bias, out, lse, out_lo)
        return out

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = mha_bwd(*ctx.saved_tensors[:4], g, ctx.rate, ctx.seed,
                             *ctx.saved_tensors[4:])
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
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return MhaFunction.apply(q, k, v, bias.float(), rate, seed)
        # no backward to feed: K1 alone, writing no LSE or remainder
        return mha_fwd(q, k, v, bias.float(), rate, seed)
    if impl == "xla":
        return _mha_torch(q, k, v, bias, rate, seed)
    raise ValueError(f"unknown attention impl {impl!r}")
