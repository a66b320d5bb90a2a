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

import struct

import torch
import torch.nn.functional as F

from uniter_tpu_torch.ops import _kernels
from uniter_tpu_torch.ops.activations import gelu

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
INV_SQRT2 = 0.7071067811865476
INV_SQRT_2PI = 0.3989422804014327
# csrc/ffn.cu keeps a row tile of x and its y accumulator on chip: D_in
# and D_out up to 1024 (uniter-large), every width a multiple of 16
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


# csrc/ffn.cu's tiling: the bf16 kernel's 64-row tiles, 64-column units
# (64 deep along K) and 256-column chunks of h; the fp32 kernel's 32-row
# tiles and 256-column chunks
BF16_ROWS, UNIT, BF16_CHUNK = 64, 64, 256
F32_ROWS, F32_CHUNK = 32, 256


def _ffn_tiled_torch(x2, w1, b1, w2, b2):
    """``ffn_plain`` in K9's order of operations, for the CPU tests. bf16
    (``ffn_wgmma_kernel``): per 64-row tile and 256-column chunk of h, each
    64-column h unit v is a sum over 64-deep steps of D_in of partial
    products (64 products each), added in order in fp32; + b1, GELU, one
    rounding; quarter v of D_out (``NUW`` units) then adds the chunk's h
    units in the order v, v ^ 1, v ^ 2, v ^ 3. fp32 (``ffn_f32_kernel``):
    per 32-row tile, 256-column chunks of h, each added to y in turn. The
    result is rounded once, after + b2. Sums inside a partial keep torch's
    order: this repeats the kernels' structure, not their bits."""
    dt = x2.dtype
    xf, w1f, w2f = (_f32(t.to(dt)) for t in (x2, w1, w2))
    b1f, b2f = _f32(b1), _f32(b2)
    rows, d_in = xf.shape
    d_mid, d_out = w1f.shape[0], w2f.shape[0]
    y = torch.empty((rows, d_out), dtype=xf.dtype)
    if dt != torch.bfloat16:
        for r0 in range(0, rows, F32_ROWS):
            xt = xf[r0:r0 + F32_ROWS]
            acc = xt.new_zeros((xt.shape[0], d_out))
            for c0 in range(0, d_mid, F32_CHUNK):
                h = _gelu(xt @ w1f[c0:c0 + F32_CHUNK].t()
                          + b1f[c0:c0 + F32_CHUNK])
                acc += h @ w2f[:, c0:c0 + F32_CHUNK].t()
            y[r0:r0 + F32_ROWS] = acc + b2f
        return y.to(dt)
    units = -(-d_out // UNIT)
    quarter = -(-units // 4) * UNIT  # the columns of a warpgroup
    for r0 in range(0, rows, BF16_ROWS):
        xt = xf[r0:r0 + BF16_ROWS]
        acc = [xt.new_zeros((xt.shape[0], w2f[q * quarter:(q + 1) * quarter]
                             .shape[0])) for q in range(4)]
        for c0 in range(0, d_mid, BF16_CHUNK):
            hu = []
            for v in range(4):
                m = slice(c0 + v * UNIT, c0 + (v + 1) * UNIT)
                h = 0.0
                for k0 in range(0, d_in, UNIT):
                    h = h + xt[:, k0:k0 + UNIT] @ w1f[m, k0:k0 + UNIT].t()
                hu.append(_f32(_gelu(h + b1f[m]).to(dt)))
            for v in range(4):
                w2v = w2f[v * quarter:(v + 1) * quarter]
                for uu in range(4):
                    u = v ^ uu
                    m = slice(c0 + u * UNIT, c0 + (u + 1) * UNIT)
                    acc[v] += hu[u] @ w2v[:, m].t()
        y[r0:r0 + BF16_ROWS] = torch.cat(acc, 1) + b2f
    return y.to(dt)


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
    """The rules every input obeys: a non-empty [rows, D_in] x, w1 [D_mid,
    D_in], b1 [D_mid], w2 [D_out, D_mid], b2 [D_out], all on x's device,
    which is the CPU or a card."""
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
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ffn_fwd runs on cuda or cpu, not {x2.device}")


def _check_card(x2, w1, b1, w2, b2):
    """What the kernel takes beyond ``_check_shapes``'s rules: float32 or
    bfloat16 x with weights of its dtype, D_in and D_out multiples of 16 up
    to 1024, D_mid a multiple of 16, every tensor contiguous. Raises on the
    first rule broken. What ``_fits`` refuses and this passes is fixed by a
    copy (a tensor not 16-byte aligned, biases not float32)."""
    d_in, d_mid, d_out = x2.shape[1], w1.shape[0], w2.shape[0]
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


def _fits(x2, w1, b1, w2, b2):
    """One look at each tensor: True when a launch takes them as they are
    (x's device aside). False sends the wrapper to ``_check_shapes`` and
    ``_check_card``, which raise on what is wrong, and to the copies."""
    shape = x2.shape
    if len(shape) != 2:
        return False
    rows, d_in = shape
    d_mid, d_out = w1.shape[0], w2.shape[0]
    dt, dev = x2.dtype, x2.device
    if (dt not in _DTYPE_CODE or not rows or d_in % 16 or d_mid % 16
            or d_out % 16 or not 0 < d_in <= MAX_WIDTH or not d_mid
            or not 0 < d_out <= MAX_WIDTH):
        return False
    for t, want in ((x2, shape), (w1, (d_mid, d_in)), (w2, (d_out, d_mid))):
        if (t.device != dev or t.dtype != dt or t.shape != want
                or not t.is_contiguous() or t.data_ptr() % 16):
            return False
    for t, want in ((b1, (d_mid,)), (b2, (d_out,))):
        if (t.device != dev or t.dtype != torch.float32 or t.shape != want
                or not t.is_contiguous()):
            return False
    return True


def _aligned(t):
    """``t`` itself when 16-byte aligned (TMA's and cp.async's rule), else
    an aligned copy."""
    return t.clone() if t.data_ptr() % 16 else t


# csrc/ffn.cu `FfnCall`, the entry's one argument: x w1 b1 w2 b2 y, rows,
# D_in, D_mid, D_out, dtype, device, stream
_CALL = struct.Struct("<6Qq6iQ")


def ffn_fwd(x2, w1, b1, w2, b2):
    """K9: ``ffn_plain`` on ``x2`` [rows, D_in] (float32 or bfloat16; w1
    [D_mid, D_in] and w2 [D_out, D_mid] in x's dtype; biases of any float
    dtype, added in fp32). A CPU input takes ``ffn_plain``; a CUDA input
    launches the kernel or raises (contiguous tensors, D_in and D_out
    multiples of 16 up to 1024, D_mid a multiple of 16). The launch path is
    the tails' (``ops/fused_block.py``): one look at each tensor in the
    common case, the entry point resolved once, the raw handle of x's
    card's current stream, one packed argument block, the device switch in
    C. No [rows, D_mid] buffer is allocated: the intermediate stays on
    chip."""
    if not (x2.is_cuda and _fits(x2, w1, b1, w2, b2)):
        _check_shapes(x2, w1, b1, w2, b2)
        if x2.device.type == "cpu":
            return ffn_plain(x2, w1, b1, w2, b2)
        _check_card(x2, w1, b1, w2, b2)
        x2, w1, w2 = _aligned(x2), _aligned(w1), _aligned(w2)
        b1, b2 = b1.float(), b2.float()
    rows, d_in = x2.shape
    d_mid, d_out = w1.shape[0], w2.shape[0]
    y = torch.empty((rows, d_out), dtype=x2.dtype, device=x2.device)
    idx = x2.device.index
    rc = _kernels.entry("ffn_fwd")(_CALL.pack(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), rows, d_in, d_mid, d_out,
        _DTYPE_CODE[x2.dtype], idx, 0,
        torch._C._cuda_getCurrentRawStream(idx)))
    if rc:
        raise RuntimeError(f"ffn_fwd kernel launch failed: cudaError_t {rc} "
                           f"at rows {rows}, ({d_in}, {d_mid}, {d_out}) "
                           f"{x2.dtype}")
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
