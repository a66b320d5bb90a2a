"""The fused dropout + residual + LayerNorm tails: plain torch versions and
the K3-K6 kernels.

Counterpart of ``uniter_tpu/ops/fused_block.py``. Two tails, over the last
axis of ``[..., H]``:

* ``drop_res_ln``: ``LayerNorm(dropout(x) + res) * w + b``, the tail of both
  BERT sub-blocks (reference model/layer.py:104-127,158-170); K3 forward
  (``_fwd_kernel``), K4 backward (``_bwd_kernel``).
* ``ln_drop``: ``dropout(LayerNorm(x) * w + b)``, the embedding tails
  (reference model/model.py:241-244,269-271); K5 forward
  (``_ln_drop_fwd_kernel``), K6 backward (``_ln_drop_bwd_kernel``).

Arithmetic is fp32 whatever the input dtype (float64 stays float64, for
gradient checks of the plain versions on the CPU); the statistics are the
mean and the mean of squared deviations (``ops.layer_norm._ln_stats``), eps
1e-12 by default; results come back in x's dtype, dw and db in fp32.
Dropout keeps an
element iff its Philox word of ``ops.dropout.keep_mask(seed, 0, x.shape,
rate)`` is >= floor(rate * 2**32) and scales it by 1 / (1 - rate): the bits
of the trunk's plain composition, so the kernels and both plain paths drop
the same elements from one seed.

``_drop_res_ln_torch`` and ``_ln_drop_torch`` are the plain forwards,
``_drop_res_ln_bwd_torch`` and ``_ln_drop_bwd_torch`` the explicit backward
formulas of the kernel bodies (the LayerNorm backward of
``uniter_tpu/ops/layer_norm.py`` ``_ln_bwd``), not autograd. The wrappers
``drop_res_ln_fwd/bwd`` and ``ln_drop_fwd/bwd`` launch the CUDA kernels
(``csrc/fused_tail.cu``) for CUDA tensors and take the plain versions for CPU
tensors; each counts its launches in ``.launches``. ``DropResLNFunction``
and ``LNDropFunction`` pair them as the JAX package's custom VJPs do,
saving only the inputs and the seed (no mask, no statistics).
"""

from __future__ import annotations

import torch

from uniter_tpu_torch.ops import _kernels
from uniter_tpu_torch.ops.dropout import keep_mask, threshold
from uniter_tpu_torch.ops.layer_norm import (
    _col_sum, _f32, _ln_bwd, _ln_stats, _prep)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HIDDEN = 1024  # csrc/fused_tail.cu keeps a row in one warp's registers


def _keep(x, rate, seed):
    return keep_mask(seed, 0, x.shape, rate, x.device)


def _dropped(t, keep, rate):
    return torch.where(keep, t * (1.0 / (1.0 - rate)),
                       torch.zeros((), dtype=t.dtype, device=t.device))


def _drop_res_ln_t(x, res, rate, seed):
    t = _f32(x)
    keep = _keep(x, rate, seed) if rate > 0.0 else None
    if keep is not None:
        t = _dropped(t, keep, rate)
    return t + _f32(res), keep


def _drop_res_ln_torch(x, res, weight, bias, rate: float = 0.0,
                       seed: int = 0, eps: float = 1e-12):
    """LN(dropout(x) + res) * w + b in fp32, in x's dtype."""
    t, _ = _drop_res_ln_t(x, res, rate, seed)
    that, _ = _ln_stats(t, eps)
    return (that * _f32(weight) + _f32(bias)).to(x.dtype)


def _drop_res_ln_bwd_torch(x, res, weight, g, rate: float = 0.0,
                           seed: int = 0, eps: float = 1e-12):
    """(dx, dres, dw, db) by the formula of ``_bwd_kernel``: replay the
    mask, recompute the statistics, dres = dt, dx = mask(dt) / (1 - rate),
    dw = sum(g * x_hat), db = sum(g)."""
    t, keep = _drop_res_ln_t(x, res, rate, seed)
    that, inv = _ln_stats(t, eps)
    gf = _f32(g)
    dt = _ln_bwd(that, inv, gf * _f32(weight))
    dx = _dropped(dt, keep, rate) if keep is not None else dt
    return (dx.to(x.dtype), dt.to(x.dtype), _col_sum(gf * that),
            _col_sum(gf))


def _ln_drop_torch(x, weight, bias, rate: float = 0.0, seed: int = 0,
                   eps: float = 1e-12):
    """dropout(LN(x) * w + b) in fp32, in x's dtype."""
    that, _ = _ln_stats(_f32(x), eps)
    y = that * _f32(weight) + _f32(bias)
    if rate > 0.0:
        y = _dropped(y, _keep(x, rate, seed), rate)
    return y.to(x.dtype)


def _ln_drop_bwd_torch(x, weight, g, rate: float = 0.0, seed: int = 0,
                       eps: float = 1e-12):
    """(dx, dw, db) by the formula of ``_ln_drop_bwd_kernel``: g masked and
    rescaled, then the LayerNorm backward."""
    that, inv = _ln_stats(_f32(x), eps)
    gf = _f32(g)
    if rate > 0.0:
        gf = _dropped(gf, _keep(x, rate, seed), rate)
    dx = _ln_bwd(that, inv, gf * _f32(weight))
    return dx.to(x.dtype), _col_sum(gf * that), _col_sum(gf)


def _check(name, rows_like, vecs, rate, seed):
    """Devices, dtypes, shapes, contiguity, alignment, rate and seed; the
    CPU also takes float64 (the plain versions keep it)."""
    x = rows_like[0]
    dev = x.device
    if any(t.device != dev for t in (*rows_like, *vecs)):
        raise ValueError(f"{name}: all tensors must lie on one device")
    ok = dict(_DTYPE_CODE)
    if dev.type == "cpu":
        ok[torch.float64] = None
    if x.dtype not in ok or any(t.dtype != x.dtype for t in rows_like):
        raise TypeError(f"{name} takes float32 or bfloat16 activations of "
                        f"one dtype, got {[str(t.dtype) for t in rows_like]}")
    vdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    if any(t.dtype != vdt for t in vecs):
        raise TypeError(f"{name}: weight and bias must be {vdt}")
    h = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"{name}: needs a non-empty [..., H] tensor, got "
                         f"{tuple(x.shape)}")
    if any(t.shape != x.shape for t in rows_like) or any(
            tuple(t.shape) != (h,) for t in vecs):
        raise ValueError(f"{name}: shapes differ: "
                         f"{[tuple(t.shape) for t in (*rows_like, *vecs)]}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    if not 0 <= int(seed) < 2**63:
        raise ValueError(f"seed must be a non-negative 64-bit int, got {seed}")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if h % 4 or h > MAX_HIDDEN:
        raise ValueError(f"{name}: hidden size must be a multiple of 4 up to "
                         f"{MAX_HIDDEN}, got {h}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in rows_like):
        raise ValueError(f"{name}: activations must be contiguous and "
                         f"16-byte aligned")
    if any(not t.is_contiguous() for t in vecs):
        raise ValueError(f"{name}: weight and bias must be contiguous")


def _tail_args(x, rate, seed, eps):
    rows = x.numel() // x.shape[-1]
    return (rows, x.shape[-1], threshold(rate) if rate > 0.0 else 0,
            1.0 / (1.0 - rate), int(seed), float(eps), _DTYPE_CODE[x.dtype])


def _launch(name, x, ptrs, rate, seed, eps):
    fn = getattr(_kernels.load(name), f"uniter_{name}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in ptrs),
                *_tail_args(x, rate, seed, eps), stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc} "
                           f"at {tuple(x.shape)} {x.dtype}")


def _bwd_scratch(x):
    rows, h = x.numel() // x.shape[-1], x.shape[-1]
    n_blocks = min((rows + 3) // 4, 4 * 132)  # csrc/fused_tail.cu bwd grid
    return (torch.empty((2, n_blocks, h), dtype=torch.float32,
                        device=x.device),
            torch.empty((2, h), dtype=torch.float32, device=x.device))


def drop_res_ln_fwd(x, res, weight, bias, rate: float = 0.0, seed: int = 0,
                    eps: float = 1e-12):
    """K3: LN(dropout(x) + res) * w + b over the last axis. A CPU input
    takes ``_drop_res_ln_torch``; a CUDA input launches the kernel or
    raises. Rate 0 draws no bits."""
    _check("drop_res_ln_fwd", (x, res), (weight, bias), rate, seed)
    if x.device.type == "cpu":
        return _drop_res_ln_torch(x, res, weight, bias, rate, seed, eps)
    y = torch.empty_like(x)
    _launch("drop_res_ln_fwd", x, (x, res, weight, bias, y), rate, seed, eps)
    drop_res_ln_fwd.launches += 1
    return y


drop_res_ln_fwd.launches = 0


def drop_res_ln_bwd(x, res, weight, g, rate: float = 0.0, seed: int = 0,
                    eps: float = 1e-12):
    """K4: (dx, dres, dw, db) of ``drop_res_ln_fwd`` (same rate and seed)
    for the output gradient ``g``; dx and dres in x's dtype, dw and db fp32.
    A CPU input takes ``_drop_res_ln_bwd_torch``. One launch per call (the
    kernel and its ordered sum of the per-block dw/db partials run back to
    back on the stream)."""
    _check("drop_res_ln_bwd", (x, res, g), (weight,), rate, seed)
    if x.device.type == "cpu":
        return _drop_res_ln_bwd_torch(x, res, weight, g, rate, seed, eps)
    dx, dres = torch.empty_like(x), torch.empty_like(x)
    part, dwdb = _bwd_scratch(x)
    _launch("drop_res_ln_bwd", x, (x, res, weight, g, dx, dres, part, dwdb),
            rate, seed, eps)
    drop_res_ln_bwd.launches += 1
    return dx, dres, dwdb[0], dwdb[1]


drop_res_ln_bwd.launches = 0


def ln_drop_fwd(x, weight, bias, rate: float = 0.0, seed: int = 0,
                eps: float = 1e-12):
    """K5: dropout(LN(x) * w + b) over the last axis; a CPU input takes
    ``_ln_drop_torch``."""
    _check("ln_drop_fwd", (x,), (weight, bias), rate, seed)
    if x.device.type == "cpu":
        return _ln_drop_torch(x, weight, bias, rate, seed, eps)
    y = torch.empty_like(x)
    _launch("ln_drop_fwd", x, (x, weight, bias, y), rate, seed, eps)
    ln_drop_fwd.launches += 1
    return y


ln_drop_fwd.launches = 0


def ln_drop_bwd(x, weight, g, rate: float = 0.0, seed: int = 0,
                eps: float = 1e-12):
    """K6: (dx, dw, db) of ``ln_drop_fwd``; a CPU input takes
    ``_ln_drop_bwd_torch``."""
    _check("ln_drop_bwd", (x, g), (weight,), rate, seed)
    if x.device.type == "cpu":
        return _ln_drop_bwd_torch(x, weight, g, rate, seed, eps)
    dx = torch.empty_like(x)
    part, dwdb = _bwd_scratch(x)
    _launch("ln_drop_bwd", x, (x, weight, g, dx, part, dwdb), rate, seed, eps)
    ln_drop_bwd.launches += 1
    return dx, dwdb[0], dwdb[1]


ln_drop_bwd.launches = 0


class DropResLNFunction(torch.autograd.Function):
    """K3 forward, K4 backward. Saves x, res, weight and the seed, as the
    JAX package's ``_drop_res_ln_fwd`` does."""

    @staticmethod
    def forward(ctx, x, res, weight, bias, rate, seed, eps):
        x, res = _prep(x), _prep(res)
        ctx.save_for_backward(x, res, weight)
        ctx.rate, ctx.seed, ctx.eps = rate, seed, eps
        return drop_res_ln_fwd(x, res, weight, bias, rate, seed, eps)

    @staticmethod
    def backward(ctx, g):
        x, res, weight = ctx.saved_tensors
        dx, dres, dw, db = drop_res_ln_bwd(x, res, weight, _prep(g), ctx.rate,
                                           ctx.seed, ctx.eps)
        return dx, dres, dw, db, None, None, None


class LNDropFunction(torch.autograd.Function):
    """K5 forward, K6 backward. Saves x, weight and the seed
    (``_ln_drop_vjp_fwd``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, rate, seed, eps):
        x = _prep(x)
        ctx.save_for_backward(x, weight)
        ctx.rate, ctx.seed, ctx.eps = rate, seed, eps
        return ln_drop_fwd(x, weight, bias, rate, seed, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, db = ln_drop_bwd(x, weight, _prep(g), ctx.rate, ctx.seed,
                                 ctx.eps)
        return dx, dw, db, None, None, None


def drop_res_ln(x, res, weight, bias, *, rate: float = 0.0, seed: int = 0,
                eps: float = 1e-12, impl: str = "cuda"):
    """``LayerNorm(dropout(x) + res)``: ``impl="cuda"`` through
    ``DropResLNFunction`` (the kernels on the card), ``"xla"`` the plain
    forward under autograd."""
    if impl == "cuda":
        return DropResLNFunction.apply(x, res, weight, bias, rate, seed, eps)
    if impl == "xla":
        return _drop_res_ln_torch(x, res, weight, bias, rate, seed, eps)
    raise ValueError(f"unknown drop_res_ln impl {impl!r}")


def ln_drop(x, weight, bias, *, rate: float = 0.0, seed: int = 0,
            eps: float = 1e-12, impl: str = "cuda"):
    """``dropout(LayerNorm(x))``: ``impl="cuda"`` through ``LNDropFunction``,
    ``"xla"`` the plain forward under autograd."""
    if impl == "cuda":
        return LNDropFunction.apply(x, weight, bias, rate, seed, eps)
    if impl == "xla":
        return _ln_drop_torch(x, weight, bias, rate, seed, eps)
    raise ValueError(f"unknown ln_drop impl {impl!r}")
