"""Multi-head self-attention: the plain torch version and the K1 kernel.

Semantics follow the reference's BertSelfAttention (model/layer.py:75-101):
scores = QK^T / sqrt(head_dim) + additive_bias; probs = softmax(scores);
out = probs @ V, with the ``(1-mask) * -10000`` padding bias of
model/model.py:342-345. The public layout is the JAX package's: q/k/v
``[B, S, H, D]``, bias ``[B, S_k]`` fp32, result ``[B, S, H, D]``.

``_mha_torch`` is the counterpart of ``uniter_tpu/ops/attention.py``
``_mha_xla``. ``mha_fwd`` wraps the hand-written CUDA kernel
(``csrc/mha_fwd.cu``, the port of ``_mha_fwd_kernel``): a CUDA tensor
always goes to the kernel, a CPU tensor to ``_mha_torch``.
"""

from __future__ import annotations

import math

import torch

from uniter_tpu_torch.ops import _kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SEQ = 512
MAX_HEAD_DIM = 128


def _mha_torch(q, k, v, bias):
    """q, k, v: [B, S, H, D]; bias: [B, S_k] additive fp32.

    Scores in fp32 (q and k upcast, as ``preferred_element_type`` does in
    JAX), scaled before the bias is added; probabilities cast to
    ``v.dtype`` before P.V."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * scale + bias[:, None, None, :].float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check(q, k, v, bias):
    if not (q.device == k.device == v.device == bias.device):
        raise ValueError("q, k, v and bias must lie on one device")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"mha_fwd takes float32 or bfloat16 q/k/v, got "
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


def mha_fwd(q, k, v, bias):
    """K1: softmax(QK^T/sqrt(D) + bias) V through the CUDA kernel.

    Takes the layout of ``multi_head_attention``. A CPU input takes the
    plain version; a CUDA input launches the kernel or raises — there is no
    fallback. ``mha_fwd.launches`` counts the kernel's launches."""
    _check(q, k, v, bias)
    if q.device.type == "cpu":
        return _mha_torch(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"mha_fwd runs on cuda or cpu, not {q.device}")
    b, s, h, d = q.shape
    fn = _kernels.load("mha_fwd").uniter_mha_fwd
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), b, s, h, d, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], 1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype],
                stream)
    if rc:
        raise RuntimeError(f"mha_fwd kernel launch failed: cudaError_t {rc} "
                           f"at q{tuple(q.shape)} {q.dtype}")
    mha_fwd.launches += 1
    return out


mha_fwd.launches = 0


def multi_head_attention(q, k, v, bias, *, impl: str = "xla",
                         dropout_rate: float = 0.0,
                         deterministic: bool = True):
    """Fused MHA. q, k, v: [B, S, H, D]; bias: [B, S] additive (0 / -10000).

    ``impl="cuda"`` takes the K1 kernel (``mha_fwd``), ``"xla"`` the plain
    version. Returns [B, S, H, D]."""
    if not deterministic and dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout arrives with the training slice of the port "
            "(K1 dropout and the K2 backward)")
    if impl == "cuda":
        return mha_fwd(q, k, v, bias.float())
    if impl == "xla":
        return _mha_torch(q, k, v, bias)
    raise ValueError(f"unknown attention impl {impl!r}")
