"""The fused feed-forward block x·W1 + b1 -> erf-GELU -> ·W2 + b2: the plain
torch version and the K9 kernel.

Counterpart of ``uniter_tpu/ops/ffn.py``. Weights are taken in torch's
``Linear`` layout, ``[out, in]``: ``w1`` is [D_mid, D_in] and ``w2`` [D_out,
D_mid] (the JAX module takes the transposes), so a layer passes its
``intermediate.dense`` and ``output.dense`` weights without a copy.

* ``ffn_plain`` repeats the Pallas kernel's arithmetic (``_ffn_fwd_kernel``
  there), not the unfused path's: x·W1 with fp32 accumulation, + b1 in
  fp32, erf-GELU in fp32, one rounding to x's dtype, ·W2 with fp32
  accumulation, + b2 in fp32, a rounding to x's dtype. The biases stay in
  their own dtype and are added in fp32.
* ``ffn_fwd`` is K9: a CUDA input launches ``csrc/ffn.cu``'s
  ``uniter_ffn_fwd`` (the [rows, D_mid] intermediate never reaches device
  memory) or raises; a CPU input takes ``ffn_plain``;
  ``ffn_fwd.launches`` counts the launches.
* ``FfnFunction`` pairs K9 with the backward of ``_ffn_bwd`` there: it
  saves the five inputs only and recomputes the intermediate in fp32 in
  plain torch (the JAX package computes that backward outside any Pallas
  kernel, so it is no kernel here either).

GELU is the erf form with a true ``erf`` in all three places (the kernel,
the plain forward, the backward); the JAX kernel's polynomial erf works
around a missing TPU lowering and differs from it by at most 1.5e-7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uniter_tpu_torch.ops import _kernels
from uniter_tpu_torch.ops.activations import gelu

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
INV_SQRT2 = 0.7071067811865476
INV_SQRT_2PI = 0.3989422804014327
# csrc/ffn.cu keeps a row tile of x and the [rows, D_out] accumulator on
# chip: D_in and D_out up to 1024 (uniter-large), every width a multiple of
# 16 (the tensor-core tile)
MAX_WIDTH = 1024


def _f32(t):
    # float64 stays float64, for gradient checks on the CPU
    return t if t.dtype == torch.float64 else t.float()


def _gelu(pre):
    """erf-GELU with the kernel's order of operations."""
    return pre * 0.5 * (1.0 + torch.erf(pre * INV_SQRT2))


def ffn_plain(x2, w1, b1, w2, b2):
    """The Pallas kernel's arithmetic on ``x2`` [rows, D_in] (module
    docstring); the result [rows, D_out] in x's dtype."""
    w1, w2 = w1.to(x2.dtype), w2.to(x2.dtype)
    h = _gelu(F.linear(_f32(x2), _f32(w1)) + _f32(b1)).to(x2.dtype)
    return (F.linear(_f32(h), _f32(w2)) + _f32(b2)).to(x2.dtype)


def _ffn_bwd_torch(x2, w1, b1, w2, b2, g):
    """(dx, dw1, db1, dw2, db2) of ``ffn_plain`` for the output gradient
    ``g``, the formula of ``_ffn_bwd``: the intermediate recomputed and
    everything in fp32, dx in x's dtype and each weight's and bias's
    gradient in its own dtype."""
    x32, w1f, w2f, g32 = _f32(x2), _f32(w1), _f32(w2), _f32(g)
    pre = F.linear(x32, w1f) + _f32(b1)
    h = _gelu(pre)
    cdf = 0.5 * (1.0 + torch.erf(pre * INV_SQRT2))
    pdf = torch.exp(-0.5 * pre * pre) * INV_SQRT_2PI
    dpre = (g32 @ w2f) * (cdf + pre * pdf)
    return ((dpre @ w1f).to(x2.dtype), (dpre.t() @ x32).to(w1.dtype),
            dpre.sum(0).to(b1.dtype), (g32.t() @ h).to(w2.dtype),
            g32.sum(0).to(b2.dtype))


def _check_shapes(x2, w1, b1, w2, b2):
    if x2.dim() != 2 or x2.shape[0] == 0:
        raise ValueError(f"ffn_fwd: x must be a non-empty [rows, D_in] "
                         f"tensor, got {tuple(x2.shape)}")
    d_in = x2.shape[1]
    d_mid, d_out = w1.shape[0], w2.shape[0]
    want = {"w1": (d_mid, d_in), "b1": (d_mid,), "w2": (d_out, d_mid),
            "b2": (d_out,)}
    for name, t in zip(want, (w1, b1, w2, b2)):
        if tuple(t.shape) != want[name] or t.device != x2.device:
            raise ValueError(f"ffn_fwd: {name} must be {want[name]} on "
                             f"{x2.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    return d_in, d_mid, d_out


def _aligned(t):
    """``t`` itself when 32-byte aligned (the tensor-core loads' rule),
    else an aligned copy."""
    return t.clone() if t.data_ptr() % 32 else t


def ffn_fwd(x2, w1, b1, w2, b2):
    """K9: ``ffn_plain`` on ``x2`` [rows, D_in] (float32 or bfloat16; w1
    [D_mid, D_in] and w2 [D_out, D_mid] in x's dtype; biases of any float
    dtype, added in fp32). A CPU input takes ``ffn_plain``; a CUDA input
    launches the kernel or raises (contiguous tensors, D_in and D_out
    multiples of 16 up to 1024, D_mid a multiple of 16)."""
    d_in, d_mid, d_out = _check_shapes(x2, w1, b1, w2, b2)
    dev = x2.device
    if dev.type == "cpu":
        return ffn_plain(x2, w1, b1, w2, b2)
    if dev.type != "cuda":
        raise ValueError(f"ffn_fwd runs on cuda or cpu, not {dev}")
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"ffn_fwd takes float32 or bfloat16 activations, "
                        f"got {x2.dtype}")
    if w1.dtype != x2.dtype or w2.dtype != x2.dtype:
        raise TypeError(f"ffn_fwd: weights must be {x2.dtype} like x, got "
                        f"{w1.dtype}, {w2.dtype}")
    if (d_in % 16 or d_mid % 16 or d_out % 16 or d_in > MAX_WIDTH
            or d_out > MAX_WIDTH):
        raise ValueError(f"ffn_fwd: widths must be multiples of 16 with "
                         f"D_in, D_out <= {MAX_WIDTH}; got D_in {d_in}, "
                         f"D_mid {d_mid}, D_out {d_out}")
    if not all(t.is_contiguous() for t in (x2, w1, b1, w2, b2)):
        raise ValueError("ffn_fwd: x, the weights and the biases must be "
                         "contiguous")
    x2, w1, w2 = _aligned(x2), _aligned(w1), _aligned(w2)
    b1, b2 = b1.float().contiguous(), b2.float().contiguous()
    y = torch.empty((x2.shape[0], d_out), dtype=x2.dtype, device=dev)
    fn = _kernels.load("ffn_fwd").uniter_ffn_fwd
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), y.data_ptr(), x2.shape[0], d_in, d_mid, d_out,
                _DTYPE_CODE[x2.dtype], stream)
    if rc:
        raise RuntimeError(f"ffn_fwd kernel launch failed: cudaError_t {rc} "
                           f"at rows {x2.shape[0]}, ({d_in}, {d_mid}, "
                           f"{d_out}) {x2.dtype}")
    ffn_fwd.launches += 1
    return y


ffn_fwd.launches = 0


class FfnFunction(torch.autograd.Function):
    """K9 forward, the plain fp32 recompute backward. Saves the five inputs
    only, as the JAX package's ``_ffn_fwd`` does."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2):
        ctx.save_for_backward(x2, w1, b1, w2, b2)
        return ffn_fwd(x2, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        return _ffn_bwd_torch(*ctx.saved_tensors, g)


def ffn(x, w1, b1, w2, b2, *, impl: str = "xla"):
    """[..., D_in] -> [..., D_out] feed-forward block (``ffn`` there).
    ``impl="cuda"`` casts the weights to x's dtype and runs the rows
    through ``FfnFunction`` (K9 on the card); ``"xla"`` is the unfused
    Linear -> GELU -> Linear with everything in x's dtype."""
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    if impl == "cuda":
        out = FfnFunction.apply(x.reshape(-1, x.shape[-1]).contiguous(),
                                w1, b1, w2, b2)
        return out.reshape(*x.shape[:-1], w2.shape[0])
    if impl == "xla":
        h = gelu(F.linear(x, w1, b1.to(x.dtype)))
        return F.linear(h, w2, b2.to(x.dtype))
    raise ValueError(f"unknown ffn impl {impl!r}")
