"""LayerNorm with fp32 statistics (replaces apex ``FusedLayerNorm(eps=1e-12)``,
reference model/model.py:229): the plain torch version and the K8 kernel.

Counterpart of ``uniter_tpu/ops/layer_norm.py``. Statistics run in fp32
whatever the input dtype (two passes: the mean, then the mean of squared
deviations) and the result is cast back to it.

* ``_layer_norm_torch`` is the plain version (``_layer_norm_xla`` there):
  the LayerNorm of ``layer_norm_impl="xla"``, under autograd.
* ``layer_norm_fwd`` is K8 (``_ln_fwd_kernel`` there): a CUDA input
  launches ``csrc/fused_tail.cu``'s ``uniter_layer_norm_fwd`` or raises, a
  CPU input takes the plain version; ``layer_norm_fwd.launches`` counts
  the launches.
* ``LayerNormFunction`` pairs K8 with the backward of ``_ln_bwd`` there:
  it saves ``(x, weight)`` only and recomputes the statistics in fp32 in
  plain torch. The JAX package computes that backward outside any Pallas
  kernel, so it is no kernel here either.

The tails fuse the LayerNorm with dropout and the residual in
``ops/fused_block.py``: K3-K6 while a mask is live and ``block_fusion``
asks, K3/K5 at rate 0 on the card in a forward that records no gradient
(``models/encoder.py``); every other LayerNorm (the image embeddings' two,
the heads', every tail neither route takes) comes here.
"""

from __future__ import annotations

import torch

from uniter_tpu_torch.ops import _kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HIDDEN = 2048  # csrc/fused_tail.cu keeps a row in one warp's registers


def _f32(t):
    # float64 stays float64, for gradient checks on the CPU
    return t if t.dtype == torch.float64 else t.float()


def _ln_stats(t, eps):
    """(x_hat, 1/sqrt(var + eps)) over the last axis, two passes."""
    mean = t.mean(-1, keepdim=True)
    var = (t - mean).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (t - mean) * inv, inv


def _ln_bwd(that, inv, gw):
    """dt of the LayerNorm for g*w = ``gw`` (``_ln_bwd``)."""
    return inv * (gw - gw.mean(-1, keepdim=True)
                  - that * (gw * that).mean(-1, keepdim=True))


def _col_sum(t):
    return t.reshape(-1, t.shape[-1]).sum(0)


def _prep(t):
    """Contiguous and 16-byte aligned (a copy only when it is not)."""
    t = t.contiguous()
    return t.clone() if t.device.type == "cuda" and t.data_ptr() % 16 else t


def _layer_norm_torch(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    that, _ = _ln_stats(_f32(x), eps)
    return (that * _f32(weight) + _f32(bias)).to(x.dtype)


def _layer_norm_bwd_torch(x, weight, g, eps: float = 1e-12):
    """(dx, dw, db) of the LayerNorm for the output gradient ``g``, the
    formula of ``_ln_bwd``: statistics recomputed, everything in fp32, dx
    in x's dtype, dw and db in the weight's."""
    that, inv = _ln_stats(_f32(x), eps)
    gf = _f32(g)
    dx = _ln_bwd(that, inv, gf * _f32(weight))
    return (dx.to(x.dtype), _col_sum(gf * that).to(weight.dtype),
            _col_sum(gf).to(weight.dtype))


def _fits(x, weight, bias):
    """One look at each tensor: True when a launch takes them as they are
    (x's device aside). False sends the wrapper to ``_check``, which raises
    on what is wrong."""
    shape = x.shape
    h = shape[-1] if shape else 0
    if (x.dtype not in _DTYPE_CODE or not 0 < h <= MAX_HIDDEN or h % 4
            or not x.numel() or not x.is_contiguous() or x.data_ptr() % 16):
        return False
    dev = x.device
    for t in (weight, bias):
        if (t.device != dev or t.dtype != torch.float32 or t.shape != (h,)
                or not t.is_contiguous()):
            return False
    return True


def _check(x, weight, bias):
    """The rules every input obeys: one device, a non-empty [..., H] x,
    [H] weight and bias. A CUDA input then goes through ``_check_card``."""
    dev = x.device
    if weight.device != dev or bias.device != dev:
        raise ValueError("layer_norm_fwd: all tensors must lie on one device")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"layer_norm_fwd: needs a non-empty [..., H] "
                         f"tensor, got {tuple(x.shape)}")
    h = x.shape[-1]
    if tuple(weight.shape) != (h,) or tuple(bias.shape) != (h,):
        raise ValueError(f"layer_norm_fwd: weight and bias must be [{h}], "
                         f"got {tuple(weight.shape)}, {tuple(bias.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"layer_norm_fwd runs on cuda or cpu, not {dev}")


def _check_card(x, weight, bias):
    """What the kernel takes beyond ``_check``'s rules: float32 or bfloat16
    x, float32 weight and bias, H a multiple of 4 up to 2048, x contiguous
    and 16-byte aligned, weight and bias contiguous. Raises on the first
    rule broken; whatever ``_fits`` refuses breaks one of these or
    ``_check``'s."""
    h = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"layer_norm_fwd takes float32 or bfloat16 "
                        f"activations, got {x.dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("layer_norm_fwd: weight and bias must be float32")
    if h % 4 or h > MAX_HIDDEN:
        raise ValueError(f"layer_norm_fwd: hidden size must be a multiple "
                         f"of 4 up to {MAX_HIDDEN}, got {h}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("layer_norm_fwd: x must be contiguous and 16-byte "
                         "aligned")
    if not weight.is_contiguous() or not bias.is_contiguous():
        raise ValueError("layer_norm_fwd: weight and bias must be contiguous")


def layer_norm_fwd(x, weight, bias, eps: float = 1e-12):
    """K8: LayerNorm over the last axis of ``x`` [..., H] (float32 or
    bfloat16; weight and bias float32 [H]), the result in x's dtype. A CPU
    input takes ``_layer_norm_torch``; a CUDA input launches the kernel or
    raises (H a multiple of 4 up to 2048, x contiguous and 16-byte
    aligned). The launch path is the tails' (``ops/fused_block.py``): one
    look at each tensor, the entry point resolved once, the raw handle of
    x's card's current stream, one packed argument block, the device switch
    in C."""
    if not (x.is_cuda and _fits(x, weight, bias)):
        _check(x, weight, bias)
        if x.device.type == "cpu":
            return _layer_norm_torch(x, weight, bias, eps)
        _check_card(x, weight, bias)
    y = torch.empty_like(x)
    h = x.shape[-1]
    idx = x.device.index
    rc = _kernels.entry("layer_norm_fwd")(_kernels.TAIL_CALL.pack(
        x.data_ptr(), 0, weight.data_ptr(), bias.data_ptr(), y.data_ptr(), 0,
        0, 0, x.numel() // h, h, 0, 1.0, 0, 0, float(eps),
        _DTYPE_CODE[x.dtype], idx, torch._C._cuda_getCurrentRawStream(idx),
        0))
    if rc:
        raise RuntimeError(f"layer_norm_fwd kernel launch failed: "
                           f"cudaError_t {rc} at {tuple(x.shape)} {x.dtype}")
    layer_norm_fwd.launches += 1
    return y


layer_norm_fwd.launches = 0


class LayerNormFunction(torch.autograd.Function):
    """K8 forward, the plain fp32 recompute backward. Saves x and weight, as
    the JAX package's ``_ln_fwd`` does (no statistics)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x = _prep(x)
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return layer_norm_fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, db = _layer_norm_bwd_torch(x, weight, g, ctx.eps)
        return dx, dw, db, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12, impl: str = "xla") -> torch.Tensor:
    """LayerNorm over the last axis. ``impl="xla"`` is the plain version
    under autograd, ``"cuda"`` goes through ``LayerNormFunction`` (K8 on the
    card)."""
    if impl == "cuda":
        return LayerNormFunction.apply(x, weight, bias, eps)
    if impl == "xla":
        return _layer_norm_torch(x, weight, bias, eps)
    raise ValueError(f"unknown layer_norm impl {impl!r}")
