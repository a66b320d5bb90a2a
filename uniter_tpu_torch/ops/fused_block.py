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
rate, row_base=row_base)`` is >= floor(rate * 2**32) and scales it by
1 / (1 - rate): the bits of the trunk's plain composition, so the kernels
and both plain paths drop the same elements from one seed. Every function
takes the row base (default 0) beside the seed; a rank holding examples
b0... of a [B, S, H] batch passes ``b0*S``, and its mask is the global
mask's block.

``_drop_res_ln_torch`` and ``_ln_drop_torch`` are the plain forwards,
``_drop_res_ln_bwd_torch`` and ``_ln_drop_bwd_torch`` the explicit backward
formulas of the kernel bodies (the LayerNorm backward of
``uniter_tpu/ops/layer_norm.py`` ``_ln_bwd``), not autograd. The wrappers
``drop_res_ln_fwd/bwd`` and ``ln_drop_fwd/bwd`` launch the CUDA kernels
(``csrc/fused_tail.cu``) for CUDA tensors and take the plain versions for CPU
tensors; each counts its launches in ``.launches``. ``inference_tail`` is
the unmasked forward of either tail at rate 0 where a launch takes the
tensors, and None elsewhere. ``DropResLNFunction`` and ``LNDropFunction``
pair them as the JAX package's custom VJPs do, saving only the inputs and
the seed (no mask, no statistics).

The backward kernels sum dw/db over their blocks in a fixed order;
``multiway_tail_fwd`` is the pre-LN, two-expert form of K3/K5 at inference
(BEiT-3's layers, ``models/beit3.py``): the rows of each sequence before a
split position take one weight set and the rest another, and K3's form
also returns the sum it normalised (a pre-LN layer's residual stream);
``_multiway_tail_torch`` is its plain version.

``_sum_partials_torch`` is that sum in torch, which the card run holds the
kernels' dw/db to bit for bit. A wrapper's launch path is kept short, since
a step makes 52 tail calls: ``_launchable`` looks once at each tensor and
sends only what fails to the full ``_check`` (which raises); the ctypes
entry points and the backward's grid are resolved once; the stream is the
current one of x's card, with no device switch in Python.
"""

from __future__ import annotations

import torch

from uniter_tpu_torch.ops import _kernels
from uniter_tpu_torch.ops.dropout import keep_mask, threshold
from uniter_tpu_torch.ops.layer_norm import (
    _col_sum, _f32, _ln_bwd, _ln_stats, _prep)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HIDDEN = 1024  # csrc/fused_tail.cu keeps a row in one warp's registers
SUM_SLICES = 16  # csrc/fused_tail.cu SUM_WARPS: the slices of the dw/db tree


def _keep(x, rate, seed, row_base=0):
    return keep_mask(seed, 0, x.shape, rate, x.device, row_base=row_base)


def _dropped(t, keep, rate):
    return torch.where(keep, t * (1.0 / (1.0 - rate)),
                       torch.zeros((), dtype=t.dtype, device=t.device))


def _drop_res_ln_t(x, res, rate, seed, row_base=0):
    t = _f32(x)
    keep = _keep(x, rate, seed, row_base) if rate > 0.0 else None
    if keep is not None:
        t = _dropped(t, keep, rate)
    return t + _f32(res), keep


def _drop_res_ln_torch(x, res, weight, bias, rate: float = 0.0,
                       seed: int = 0, eps: float = 1e-12, row_base: int = 0):
    """LN(dropout(x) + res) * w + b in fp32, in x's dtype."""
    t, _ = _drop_res_ln_t(x, res, rate, seed, row_base)
    that, _ = _ln_stats(t, eps)
    return (that * _f32(weight) + _f32(bias)).to(x.dtype)


def _drop_res_ln_bwd_torch(x, res, weight, g, rate: float = 0.0,
                           seed: int = 0, eps: float = 1e-12,
                           row_base: int = 0):
    """(dx, dres, dw, db) by the formula of ``_bwd_kernel``: replay the
    mask, recompute the statistics, dres = dt, dx = mask(dt) / (1 - rate),
    dw = sum(g * x_hat), db = sum(g)."""
    t, keep = _drop_res_ln_t(x, res, rate, seed, row_base)
    that, inv = _ln_stats(t, eps)
    gf = _f32(g)
    dt = _ln_bwd(that, inv, gf * _f32(weight))
    dx = _dropped(dt, keep, rate) if keep is not None else dt
    return (dx.to(x.dtype), dt.to(x.dtype), _col_sum(gf * that),
            _col_sum(gf))


def _ln_drop_torch(x, weight, bias, rate: float = 0.0, seed: int = 0,
                   eps: float = 1e-12, row_base: int = 0):
    """dropout(LN(x) * w + b) in fp32, in x's dtype."""
    that, _ = _ln_stats(_f32(x), eps)
    y = that * _f32(weight) + _f32(bias)
    if rate > 0.0:
        y = _dropped(y, _keep(x, rate, seed, row_base), rate)
    return y.to(x.dtype)


def _ln_drop_bwd_torch(x, weight, g, rate: float = 0.0, seed: int = 0,
                       eps: float = 1e-12, row_base: int = 0):
    """(dx, dw, db) by the formula of ``_ln_drop_bwd_kernel``: g masked and
    rescaled, then the LayerNorm backward."""
    that, inv = _ln_stats(_f32(x), eps)
    gf = _f32(g)
    if rate > 0.0:
        gf = _dropped(gf, _keep(x, rate, seed, row_base), rate)
    dx = _ln_bwd(that, inv, gf * _f32(weight))
    return dx.to(x.dtype), _col_sum(gf * that), _col_sum(gf)


def _sum_partials_torch(part):
    """dw/db from the backward kernels' per-block partials ``part`` [2, n,
    H] (fp32), summed over blocks in the kernel's fixed order
    (``csrc/fused_tail.cu`` ``sum_partials``): slice j of ``SUM_SLICES``
    adds blocks j, j + SUM_SLICES, ... one after another from 0, then the
    slice sums are added pairwise, (0+1), (2+3), ..., down to one. Every
    step is one fp32 addition, so on the same partials this equals the
    kernel's [2, H] bit for bit."""
    s = part.new_zeros((part.shape[0], SUM_SLICES, part.shape[2]))
    for i in range(0, part.shape[1], SUM_SLICES):
        blk = part[:, i:i + SUM_SLICES]
        s[:, :blk.shape[1]] += blk
    while s.shape[1] > 1:
        s = s[:, 0::2] + s[:, 1::2]
    return s[:, 0]


def _launchable(rows_like, vecs, rate, seed, row_base=0):
    """True when every tensor is as a launch wants it: the common CUDA
    case, which this checks with one look at each tensor. False sends the
    caller to ``_check``, which raises on what is wrong."""
    x = rows_like[0]
    if not (x.is_cuda and 0.0 <= rate < 1.0 and 0 <= seed < 2**63
            and 0 <= row_base < 2**62):
        return False
    dt, shape = x.dtype, x.shape
    h = shape[-1] if shape else 0
    if (dt not in _DTYPE_CODE or not 0 < h <= MAX_HIDDEN or h % 4
            or not x.numel() or not x.is_contiguous() or x.data_ptr() % 16):
        return False
    dev = x.device
    for t in rows_like[1:]:
        if (t.device != dev or t.dtype != dt or t.shape != shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            return False
    for t in vecs:
        if (t.device != dev or t.dtype != torch.float32 or t.shape != (h,)
                or not t.is_contiguous()):
            return False
    return True


def _check(name, rows_like, vecs, rate, seed, row_base=0):
    """Devices, dtypes, shapes, contiguity, alignment, rate and seed; the
    CPU also takes float64 (the plain versions keep it). Every wrapper
    comes here unless ``_launchable`` passed."""
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
    if not 0 <= int(row_base) < 2**62:
        raise ValueError(f"row base must be a non-negative 62-bit int, got "
                         f"{row_base}")
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


_grids = {}  # (kernel, device, dtype, rows, H) -> the backward's blocks


def _launch(name, x, ptrs, rate, seed, eps, n_part=0, row_base=0):
    """One launch of ``uniter_<name>`` on x's card and its current stream
    (the library switches to that card and back when it is not the
    current one). ``ptrs``: the 8 pointer slots of ``_kernels.TAIL_CALL``.
    The stream is ``torch.cuda.current_stream(x.device)``'s handle, read as
    a raw int (the getter torch's own generated kernels use): building the
    ``torch.cuda.Stream`` object costs more host time than the rest of the
    launch."""
    h = x.shape[-1]
    idx = x.device.index
    rc = _kernels.entry(name)(_kernels.TAIL_CALL.pack(
        *ptrs, x.numel() // h, h, threshold(rate) if rate > 0.0 else 0,
        1.0 / (1.0 - rate), n_part, int(seed), float(eps),
        _DTYPE_CODE[x.dtype], idx, torch._C._cuda_getCurrentRawStream(idx),
        int(row_base)))
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc} "
                           f"at {tuple(x.shape)} {x.dtype}")


def _bwd_blocks(name, x):
    """The backward's block count for x on its card: the rows of its dw/db
    scratch. The library sizes the grid (from the card's SM count); this
    asks it once per shape."""
    h = x.shape[-1]
    rows = x.numel() // h
    key = (name, x.device.index, x.dtype, rows, h)
    n = _grids.get(key)
    if n is None:
        n = _kernels.entry("tail_bwd_grid")(
            rows, h, _DTYPE_CODE[x.dtype], int(name == "drop_res_ln_bwd"),
            x.device.index)
        if n < 1:
            raise RuntimeError(f"tail_bwd_grid failed: cudaError_t {-n} at "
                               f"{tuple(x.shape)} {x.dtype}")
        _grids[key] = n
    return n


def _tail_fwd(x, res, weight, bias, rate, seed, eps, row_base=0):
    """K3 (``res`` given) or K5 (``res`` None) on checked CUDA inputs,
    counted in its wrapper's ``.launches``: y."""
    y = torch.empty_like(x)
    if res is None:
        _launch("ln_drop_fwd", x, (x.data_ptr(), 0, weight.data_ptr(),
                                   bias.data_ptr(), y.data_ptr(), 0, 0, 0),
                rate, seed, eps, row_base=row_base)
        ln_drop_fwd.launches += 1
        return y
    _launch("drop_res_ln_fwd", x, (x.data_ptr(), res.data_ptr(),
                                   weight.data_ptr(), bias.data_ptr(),
                                   y.data_ptr(), 0, 0, 0), rate, seed, eps,
            row_base=row_base)
    drop_res_ln_fwd.launches += 1
    return y


def _tail_bwd(x, res, weight, g, rate, seed, eps, row_base=0):
    """K4 (``res`` given) or K6 (``res`` None) on checked CUDA inputs, not
    counted: (dx, dres or None, the per-block dw/db partials [2, blocks,
    H], dw/db [2, H])."""
    name = "ln_drop_bwd" if res is None else "drop_res_ln_bwd"
    n = _bwd_blocks(name, x)
    h = x.shape[-1]
    dx = torch.empty_like(x)
    part = torch.empty((2, n, h), dtype=torch.float32, device=x.device)
    dwdb = torch.empty((2, h), dtype=torch.float32, device=x.device)
    if res is None:
        _launch(name, x, (x.data_ptr(), 0, weight.data_ptr(), g.data_ptr(),
                          dx.data_ptr(), 0, part.data_ptr(), dwdb.data_ptr()),
                rate, seed, eps, n, row_base)
        return dx, None, part, dwdb
    dres = torch.empty_like(x)
    _launch(name, x, (x.data_ptr(), res.data_ptr(), weight.data_ptr(),
                      g.data_ptr(), dx.data_ptr(), dres.data_ptr(),
                      part.data_ptr(), dwdb.data_ptr()), rate, seed, eps, n,
            row_base)
    return dx, dres, part, dwdb


def drop_res_ln_fwd(x, res, weight, bias, rate: float = 0.0, seed: int = 0,
                    eps: float = 1e-12, row_base: int = 0):
    """K3: LN(dropout(x) + res) * w + b over the last axis, the mask drawn
    at ``row_base``. A CPU input takes ``_drop_res_ln_torch``; a CUDA input
    launches the kernel or raises. Rate 0 draws no bits."""
    if not _launchable((x, res), (weight, bias), rate, seed, row_base):
        _check("drop_res_ln_fwd", (x, res), (weight, bias), rate, seed,
               row_base)
        if x.device.type == "cpu":
            return _drop_res_ln_torch(x, res, weight, bias, rate, seed, eps,
                                      row_base)
    return _tail_fwd(x, res, weight, bias, rate, seed, eps, row_base)


drop_res_ln_fwd.launches = 0


def drop_res_ln_bwd(x, res, weight, g, rate: float = 0.0, seed: int = 0,
                    eps: float = 1e-12, row_base: int = 0):
    """K4: (dx, dres, dw, db) of ``drop_res_ln_fwd`` (same rate and seed)
    for the output gradient ``g``; dx and dres in x's dtype, dw and db fp32.
    A CPU input takes ``_drop_res_ln_bwd_torch``. One launch per call (the
    kernel and its fixed-order sum of the per-block dw/db partials run back
    to back on the stream)."""
    if not _launchable((x, res, g), (weight,), rate, seed, row_base):
        _check("drop_res_ln_bwd", (x, res, g), (weight,), rate, seed,
               row_base)
        if x.device.type == "cpu":
            return _drop_res_ln_bwd_torch(x, res, weight, g, rate, seed, eps,
                                          row_base)
    dx, dres, _, dwdb = _tail_bwd(x, res, weight, g, rate, seed, eps,
                                  row_base)
    drop_res_ln_bwd.launches += 1
    return (dx, dres, *dwdb.unbind(0))


drop_res_ln_bwd.launches = 0


def ln_drop_fwd(x, weight, bias, rate: float = 0.0, seed: int = 0,
                eps: float = 1e-12, row_base: int = 0):
    """K5: dropout(LN(x) * w + b) over the last axis, the mask drawn at
    ``row_base``; a CPU input takes ``_ln_drop_torch``."""
    if not _launchable((x,), (weight, bias), rate, seed, row_base):
        _check("ln_drop_fwd", (x,), (weight, bias), rate, seed, row_base)
        if x.device.type == "cpu":
            return _ln_drop_torch(x, weight, bias, rate, seed, eps, row_base)
    return _tail_fwd(x, None, weight, bias, rate, seed, eps, row_base)


ln_drop_fwd.launches = 0


def ln_drop_bwd(x, weight, g, rate: float = 0.0, seed: int = 0,
                eps: float = 1e-12, row_base: int = 0):
    """K6: (dx, dw, db) of ``ln_drop_fwd``; a CPU input takes
    ``_ln_drop_bwd_torch``."""
    if not _launchable((x, g), (weight,), rate, seed, row_base):
        _check("ln_drop_bwd", (x, g), (weight,), rate, seed, row_base)
        if x.device.type == "cpu":
            return _ln_drop_bwd_torch(x, weight, g, rate, seed, eps,
                                      row_base)
    dx, _, _, dwdb = _tail_bwd(x, None, weight, g, rate, seed, eps, row_base)
    ln_drop_bwd.launches += 1
    return (dx, *dwdb.unbind(0))


ln_drop_bwd.launches = 0


def inference_tail(x, res, weight, bias, eps: float = 1e-12):
    """A tail with no mask, in one forward launch outside autograd:
    ``LN(x + res) * w + b`` (K3 at rate 0) or, with ``res`` None,
    ``LN(x) * w + b`` (K5 at rate 0); None where a launch does not take
    the tensors (``_launchable``: the CPU, float64, H past ``MAX_HIDDEN``
    or not a multiple of 4, strided or misaligned), for the caller's own
    path: a tensor ``_launchable`` refuses raises nothing."""
    rows_like = (x,) if res is None else (x, res)
    if not _launchable(rows_like, (weight, bias), 0.0, 0):
        return None
    return _tail_fwd(x, res, weight, bias, 0.0, 0, eps)


def _check_split(name, x, split):
    """A multiway tail's rows: x is [B, S, H] and 0 <= split <= S."""
    if x.dim() != 3:
        raise ValueError(f"{name}: needs a [B, S, H] tensor, got "
                         f"{tuple(x.shape)}")
    if not 0 <= int(split) <= x.shape[1]:
        raise ValueError(f"{name}: split {split} lies outside the "
                         f"{x.shape[1]} positions of a sequence")


def _multiway_tail_torch(x, res, w_a, b_a, w_b, b_b, split: int,
                         eps: float = 1e-5):
    """The plain multiway tail in fp32: with ``res``, (x + res, LN_m(x +
    res)), else LN_m(x), in x's dtype; positions < ``split`` of each
    sequence take (w_a, b_a), the rest (w_b, b_b)."""
    t = _f32(x) if res is None else _f32(x) + _f32(res)
    that, _ = _ln_stats(t, eps)
    pos = torch.arange(x.shape[1], device=x.device)[:, None] < split
    y = (that * torch.where(pos, _f32(w_a), _f32(w_b))
         + torch.where(pos, _f32(b_a), _f32(b_b))).to(x.dtype)
    return y if res is None else (t.to(x.dtype), y)


def multiway_tail_fwd(x, res, w_a, b_a, w_b, b_b, split: int,
                      eps: float = 1e-5, keep_sum: bool = True):
    """The multiway tails of a pre-LN layer (BEiT-3) at inference, in one
    launch: with ``res``, ``(x + res, LN_m(x + res))`` (K3's row code; the
    sum None unless ``keep_sum``), else ``LN_m(x)`` (K5's). x is [B, S, H];
    the positions of each sequence before ``split`` take (w_a, b_a), the
    rest (w_b, b_b). A CPU input takes ``_multiway_tail_torch``; a CUDA
    input launches ``uniter_multiway_tail_fwd`` or raises. Counted in
    ``.launches``."""
    rows_like = (x,) if res is None else (x, res)
    vecs = (w_a, b_a, w_b, b_b)
    if not (_launchable(rows_like, vecs, 0.0, 0) and x.dim() == 3
            and 0 <= split <= x.shape[1]):
        _check("multiway_tail_fwd", rows_like, vecs, 0.0, 0)
        _check_split("multiway_tail_fwd", x, split)
        if x.device.type == "cpu":
            out = _multiway_tail_torch(x, res, w_a, b_a, w_b, b_b, split,
                                       eps)
            return out if res is None or keep_sum else (None, out[1])
    h = x.shape[-1]
    y = torch.empty_like(x)
    hsum = torch.empty_like(x) if res is not None and keep_sum else None
    idx = x.device.index
    call = _kernels.MULTI_CALL.pack(
        x.data_ptr(), 0 if res is None else res.data_ptr(), w_a.data_ptr(),
        b_a.data_ptr(), y.data_ptr(), 0, 0, 0, x.numel() // h, h, 0, 1.0, 0,
        0, float(eps), _DTYPE_CODE[x.dtype], idx,
        torch._C._cuda_getCurrentRawStream(idx), 0, w_b.data_ptr(),
        b_b.data_ptr(), 0 if hsum is None else hsum.data_ptr(), x.shape[1],
        int(split))
    rc = _kernels.entry("multiway_tail_fwd")(call)
    if rc:
        raise RuntimeError(f"multiway_tail_fwd kernel launch failed: "
                           f"cudaError_t {rc} at {tuple(x.shape)} {x.dtype}")
    multiway_tail_fwd.launches += 1
    return y if res is None else (hsum, y)


multiway_tail_fwd.launches = 0


class DropResLNFunction(torch.autograd.Function):
    """K3 forward, K4 backward. Saves x, res, weight and the seed, as the
    JAX package's ``_drop_res_ln_fwd`` does."""

    @staticmethod
    def forward(ctx, x, res, weight, bias, rate, seed, eps, row_base=0):
        x, res = _prep(x), _prep(res)
        ctx.save_for_backward(x, res, weight)
        ctx.rate, ctx.seed, ctx.eps, ctx.row_base = rate, seed, eps, row_base
        return drop_res_ln_fwd(x, res, weight, bias, rate, seed, eps,
                               row_base)

    @staticmethod
    def backward(ctx, g):
        x, res, weight = ctx.saved_tensors
        dx, dres, dw, db = drop_res_ln_bwd(x, res, weight, _prep(g), ctx.rate,
                                           ctx.seed, ctx.eps, ctx.row_base)
        return dx, dres, dw, db, None, None, None, None


class LNDropFunction(torch.autograd.Function):
    """K5 forward, K6 backward. Saves x, weight and the seed
    (``_ln_drop_vjp_fwd``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, rate, seed, eps, row_base=0):
        x = _prep(x)
        ctx.save_for_backward(x, weight)
        ctx.rate, ctx.seed, ctx.eps, ctx.row_base = rate, seed, eps, row_base
        return ln_drop_fwd(x, weight, bias, rate, seed, eps, row_base)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, db = ln_drop_bwd(x, weight, _prep(g), ctx.rate, ctx.seed,
                                 ctx.eps, ctx.row_base)
        return dx, dw, db, None, None, None, None


def drop_res_ln(x, res, weight, bias, *, rate: float = 0.0, seed: int = 0,
                eps: float = 1e-12, impl: str = "cuda", row_base: int = 0):
    """``LayerNorm(dropout(x) + res)``: ``impl="cuda"`` through
    ``DropResLNFunction`` (the kernels on the card), ``"xla"`` the plain
    forward under autograd; the mask drawn at ``row_base``."""
    if impl == "cuda":
        return DropResLNFunction.apply(x, res, weight, bias, rate, seed, eps,
                                       row_base)
    if impl == "xla":
        return _drop_res_ln_torch(x, res, weight, bias, rate, seed, eps,
                                  row_base)
    raise ValueError(f"unknown drop_res_ln impl {impl!r}")


def ln_drop(x, weight, bias, *, rate: float = 0.0, seed: int = 0,
            eps: float = 1e-12, impl: str = "cuda", row_base: int = 0):
    """``dropout(LayerNorm(x))``: ``impl="cuda"`` through ``LNDropFunction``,
    ``"xla"`` the plain forward under autograd; the mask drawn at
    ``row_base``."""
    if impl == "cuda":
        return LNDropFunction.apply(x, weight, bias, rate, seed, eps,
                                    row_base)
    if impl == "xla":
        return _ln_drop_torch(x, weight, bias, rate, seed, eps, row_base)
    raise ValueError(f"unknown ln_drop impl {impl!r}")
