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
(``csrc/mha_fwd.cu``, K1, and ``csrc/mha_bwd.cu``, K2), both on the tensor
cores: bf16 on the bf16 ``mma.sync`` (K1 writes the LSE and the output's
bf16 remainder, K2 reads them and the output), fp32 on the TF32
``mma.sync`` with every product split three ways (K1 writes the LSE, K2
reads it and the fp32 output). ``_mha_tf32_torch`` and
``_mha_bwd_tf32_torch`` repeat the fp32 kernels' order of operations (TF32
rounding, the three passes, partials of at most 64 products) for the CPU
tests. A CUDA tensor always goes to a kernel, a CPU tensor to the plain
version.
``MhaFunction`` pairs them as the JAX package's custom VJP
(``_mha_pallas``, :335-351) does. It saves the output and the [B, H, S]
fp32 LSE besides q, k, v, bias and the seed (bf16 also the output's bf16
remainder), which the JAX VJP does not: the LSE is what makes K2 one pass,
and the output to fp32 precision gives Di = rowsum(g * out) as exactly as
the JAX kernel's rowsum(dP * P). The output's storage costs nothing (the
output projection saves it as its input); the LSE is 4 bytes a row, the
bf16 remainder 2 bytes an element.

Dropout on P draws its mask from ``ops.dropout.keep_mask`` over the
``[B, H, S, S]`` probabilities, score (b, h, q, k) at row
``row_base + (b*heads_total + head0 + h)*S + q``, column ``k``; the
kernels compute the same bits from the same seed, row base, total heads
and first head. Every function here takes the three (defaults 0, H and
0) beside the seed: a rank holding examples b0... of the global batch
passes ``row_base = b0*heads_total*S``, a tensor-parallel rank holding
heads h0... of ``heads_total`` passes those, and its mask is the global
mask's block.
"""

from __future__ import annotations

import functools
import math

import torch

from uniter_tpu_torch.ops import _kernels
from uniter_tpu_torch.ops.dropout import keep_mask, threshold

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# K1's tiles are fixed 64-row blocks of q, k and v whatever S is, so its
# limit is the wrapper's; K2 stages per-row statistics of the whole
# sequence in shared memory (``_bwd_smem``) and was built and checked up to
# 512, which stays its limit
MAX_SEQ = 1024
MAX_SEQ_BWD = 512
MAX_HEAD_DIM = 128
SMEM_LIMIT = 232448  # dynamic shared memory a block may opt into (227 KB)


def _f32(t):
    """fp32 arithmetic for fp32/bf16 inputs; float64 stays float64 (for
    gradient checks of the plain versions)."""
    return t if t.dtype == torch.float64 else t.float()


def head_rows(b, s, h, heads_total, head0, row_base=0, device=None):
    """The mask rows [B, h, S] of heads head0... of ``heads_total`` (module
    docstring)."""
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    return (int(row_base) + ((ar(b)[:, None, None] * int(heads_total)
                              + int(head0) + ar(h)[None, :, None]) * s
                             + ar(s)[None, None, :]))


def _probs_mask(q, rate, seed, row_base=0, heads_total=None, head0=0):
    """The keep mask [B, H, S, S] of the launch's heads (module
    docstring)."""
    b, s, h, _ = q.shape
    if heads_total is None or (int(heads_total) == h and not head0):
        return keep_mask(seed, 0, (b, h, s, s), rate, q.device,
                         row_base=row_base)
    return keep_mask(seed, 0, (b, h, s, s), rate, q.device,
                     rows_at=head_rows(b, s, h, heads_total, head0,
                                       row_base, q.device))


def _mha_torch(q, k, v, bias, rate: float = 0.0, seed: int = 0,
               return_lse: bool = False, row_base: int = 0,
               heads_total=None, head0: int = 0):
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
        probs = torch.where(_probs_mask(q, rate, seed, row_base,
                                        heads_total, head0),
                            probs / (1.0 - rate),
                            torch.zeros((), device=probs.device))
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def _mha_bwd_torch(q, k, v, bias, g, rate: float = 0.0, seed: int = 0,
                   row_base: int = 0, heads_total=None, head0: int = 0):
    """dq, dk, dv of ``_mha_torch`` by the formula of ``_mha_bwd_kernel``
    (not autograd): recompute P, replay the mask, dV = P_d^T g,
    dP = g V^T masked and rescaled, dS = P * (dP - rowsum(dP * P)) / sqrt(D),
    dQ = dS K, dK = dS^T Q; fp32 arithmetic, results in q's dtype,
    contiguous [B, S, H, D]."""
    scores = torch.einsum("bqhd,bkhd->bhqk", _f32(q), _f32(k))
    p = torch.softmax(scores * (1.0 / math.sqrt(q.shape[-1]))
                      + _f32(bias)[:, None, None, :], dim=-1)
    return _grads_from_probs(q, k, g, v, p, rate, seed, row_base=row_base,
                             heads_total=heads_total, head0=head0)


def _mha_bwd_lse_torch(q, k, v, bias, g, out, lse, rate: float = 0.0,
                       seed: int = 0, lse_lo=None, row_base: int = 0,
                       heads_total=None, head0: int = 0):
    """The gradients of ``_mha_bwd_torch`` from the forward's ``out``
    [B, S, H, D] and ``lse`` [B, H, S], as K2 computes them:
    P = exp(s - lse) with no pass over the keys first (with the LSE's
    remainder ``lse_lo``, as the fp32 K2 takes it, P = exp((s - lse) -
    lse_lo)), and Di = rowsum(g * out), which equals rowsum(dPm * P)
    (dropout included, since out = P_d V). fp32 arithmetic, results in q's
    dtype, contiguous."""
    scores = torch.einsum("bqhd,bkhd->bhqk", _f32(q), _f32(k))
    z = (scores * (1.0 / math.sqrt(q.shape[-1]))
         + _f32(bias)[:, None, None, :] - _f32(lse)[..., None])
    p = torch.exp(z if lse_lo is None else z - _f32(lse_lo)[..., None])
    di = (_f32(g) * _f32(out)).sum(-1).transpose(1, 2)  # [B, H, S]
    return _grads_from_probs(q, k, g, v, p, rate, seed, di, row_base,
                             heads_total, head0)


def _grads_from_probs(q, k, g, v, p, rate, seed, di=None, row_base=0,
                      heads_total=None, head0=0):
    """dq, dk, dv from the probabilities P [B, H, S, S]: the mask of
    ``seed`` replayed, dV = P_d^T g, dP = g V^T masked and rescaled,
    dS = P (dP - Di) / sqrt(D) with Di = rowsum(dP * P) unless given,
    dQ = dS K, dK = dS^T Q."""
    qf, kf, vf, gf = (_f32(t) for t in (q, k, v, g))
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    pd = p
    if rate > 0.0:
        keep = _probs_mask(q, rate, seed, row_base, heads_total, head0)
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


TILE = 64  # the fp32 kernels' key and query tiles, and the most products
# one tensor-core partial sums


def _tf32(x):
    """fp32 ``x`` rounded to TF32 as the kernels round it (mma.cuh
    ``tf32_rna``: half a TF32 step added to the bits, 13 low bits cleared;
    to nearest, ties away from zero)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_mm(a, b, passes=3):
    """a @ b ([..., M, K] @ [..., K, N], fp32) as the fp32 kernels form it:
    with ``passes`` 3 each operand is split into hi = tf32(x) and
    lo = tf32(x - hi) and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi; each
    partial spans at most 64 of K (the TF32 products are exact in fp32),
    and the partials add up in fp32. ``passes`` 1 is a single TF32 pass,
    a_hi b_hi (what the fp32 contract rules out)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    out = None
    for k0 in range(0, a.shape[-1], TILE):
        ks = slice(k0, k0 + TILE)
        part = ah[..., ks] @ bh[..., ks, :]
        if passes == 3:
            part = (al[..., ks] @ bh[..., ks, :] + ah[..., ks] @ bl[..., ks, :]
                    + part)
        out = part if out is None else out + part
    return out


def _mha_tf32_torch(q, k, v, bias, rate: float = 0.0, seed: int = 0,
                    return_lse: bool = False, passes: int = 3,
                    row_base: int = 0, heads_total=None, head0: int = 0):
    """``_mha_torch`` for fp32 inputs in the order of operations of the fp32
    K1 (``mha_fwd_tf32_kernel``), for the CPU tests: scores by ``_split_mm``
    (partials over at most 64 head dims), scaled and biased; keys in tiles
    of 64 with the online softmax (row max, rescale of the sum and of the
    output by exp(m_old - m_new)); the row sum takes every exp, the dropout
    mask only P V; each tile's P V one ``_split_mm`` partial; the division
    by the sum at the end. With ``return_lse`` returns (out, lse, lse_lo):
    lse = fl(m + log l) and its remainder by TwoSum, as the kernel writes
    them. Sums inside a partial keep torch's order: this repeats the
    kernel's structure, not its bits."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (t.float().transpose(1, 2) for t in (q, k, v))  # [B,H,S,D]
    scores = _split_mm(qt, kt.transpose(-1, -2), passes) * scale \
        + bias.float()[:, None, None, :]
    keep = (_probs_mask(q, rate, seed, row_base, heads_total, head0)
            if rate > 0.0 else None)
    m = l = o = None  # row max, row sum, unnormalised output
    for k0 in range(0, s, TILE):
        ks = slice(k0, k0 + TILE)
        st = scores[..., ks]
        mt = st.amax(-1)
        mn = mt if m is None else torch.maximum(m, mt)
        p = torch.exp(st - mn[..., None])
        pd = p if keep is None else torch.where(
            keep[..., ks], p * (1.0 / (1.0 - rate)), torch.zeros(()))
        part = _split_mm(pd, vt[..., ks, :], passes)
        if m is None:
            l, o = p.sum(-1), part
        else:
            alpha = torch.exp(m - mn)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + part
        m = mn
    out = (o / l[..., None]).transpose(1, 2).contiguous()
    if return_lse:
        ll = torch.log(l)
        hi = m + ll
        bb = hi - m
        return out, hi, (m - (hi - bb)) + (ll - bb)
    return out


def _mha_bwd_tf32_torch(q, k, v, bias, g, out, lse, lse_lo,
                        rate: float = 0.0, seed: int = 0, passes: int = 3,
                        row_base: int = 0, heads_total=None,
                        head0: int = 0):
    """``_mha_bwd_lse_torch`` for fp32 inputs in the order of operations of
    the fp32 K2 (``mha_bwd_tf32_kernel``), for the CPU tests: Di =
    rowsum(g * out); per 64-key tile j and 64-query tile i, S^T = K_j Q_i^T
    and dP^T = V_j g_i^T by ``_split_mm``, P = exp((s - lse) - lse_lo), P_d
    and dS in fp32, then dV_j += P_d^T g_i, dK_j += dS^T Q_i and dQ_i +=
    dS K_j, each one 64-product partial added in fp32. Results contiguous
    [B, S, H, D]."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt, gt = (t.float().transpose(1, 2) for t in (q, k, v, g))
    bias_f = bias.float()
    di = (g.float() * out.float()).sum(-1).transpose(1, 2)  # [B, H, S]
    keep = (_probs_mask(q, rate, seed, row_base, heads_total, head0)
            if rate > 0.0 else None)
    dq, dk, dv = (torch.zeros_like(qt) for _ in range(3))
    for k0 in range(0, s, TILE):
        kj = slice(k0, k0 + TILE)
        for q0 in range(0, s, TILE):
            qi = slice(q0, q0 + TILE)
            st = _split_mm(kt[..., kj, :], qt[..., qi, :].transpose(-1, -2),
                           passes)  # [B, H, keys, queries]
            dpt = _split_mm(vt[..., kj, :], gt[..., qi, :].transpose(-1, -2),
                            passes)
            p = torch.exp((st * scale + bias_f[:, None, kj, None]
                           - lse.float()[:, :, None, qi])
                          - lse_lo.float()[:, :, None, qi])
            pd, dpm = p, dpt
            if keep is not None:
                kp = keep[..., qi, kj].transpose(-1, -2)
                zero = torch.zeros(())
                pd = torch.where(kp, p * (1.0 / (1.0 - rate)), zero)
                dpm = torch.where(kp, dpt * (1.0 / (1.0 - rate)), zero)
            ds = p * (dpm - di[:, :, None, qi]) * scale
            dv[..., kj, :] += _split_mm(pd, gt[..., qi, :], passes)
            dk[..., kj, :] += _split_mm(ds, qt[..., qi, :], passes)
            dq[..., qi, :] += _split_mm(ds.transpose(-1, -2),
                                        kt[..., kj, :], passes)
    return tuple(t.transpose(1, 2).to(q.dtype).contiguous()
                 for t in (dq, dk, dv))


def _check_seq(s, name="mha_fwd"):
    """The sequence-length limit of K1 (``MAX_SEQ``) or of K2
    (``MAX_SEQ_BWD``, for ``mha_bwd`` and a forward that records a
    gradient)."""
    if name == "mha_fwd":
        if not 1 <= s <= MAX_SEQ:
            raise ValueError(f"sequence length must be 1..{MAX_SEQ}, got {s}")
    elif not 1 <= s <= MAX_SEQ_BWD:
        raise ValueError(
            f"{name}: sequence length must be 1..{MAX_SEQ_BWD}, got {s}: the "
            f"backward kernel keeps per-row statistics of the whole sequence "
            f"in shared memory and is built and checked up to {MAX_SEQ_BWD} "
            f"(the forward takes up to {MAX_SEQ})")


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
    _check_seq(s, name)
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the launch grid")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v need a contiguous head dim (stride 1)")
    if tuple(bias.shape) != (b, s) or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous [{b}, {s}] tensor, got "
                         f"{tuple(bias.shape)}")


def _check_dropout(rate, seed, row_base=0, h=1, heads_total=None, head0=0):
    """The mask's arguments; returns ``heads_total`` (H when None)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    if not 0 <= int(seed) < 2**63:
        raise ValueError(f"seed must be a non-negative 64-bit int, got {seed}")
    if not 0 <= int(row_base) < 2**62:
        raise ValueError(f"row base must be a non-negative 62-bit int, got "
                         f"{row_base}")
    heads_total = h if heads_total is None else int(heads_total)
    if not (0 <= int(head0) and int(head0) + h <= heads_total <= 65535):
        raise ValueError(f"heads {head0}..{int(head0) + h} do not lie in "
                         f"the {heads_total} heads")
    return heads_total


def _dim_pad(d):
    """The head dim the bf16 kernels pad their tiles to (zeros)."""
    return next(p for p in (16, 32, 64, 128) if d <= p)


def _bwd_smem(s, d, dtype, dq_shared=True):
    """Dynamic shared memory of the K2 block (``tf32_smem`` and ``tc_smem``
    in csrc/mha_bwd.cu). fp32: K, V, Q and g tiles, the dS tile, LSE, its
    remainder, Di and the tile's dropout bits (dQ always in device memory,
    so two blocks share an SM). bf16: K, V and double-buffered Q, g tiles,
    dS^T hi and lo, LSE, Di, the bits and, when it fits, dQ in fp32."""
    dp, s_pad = _dim_pad(d), -(-s // 64) * 64
    if dtype == torch.float32:
        return 4 * 64 * (dp + 4) * 4 + 64 * 72 * 4 + 3 * s_pad * 4 + 512
    return (6 * 64 * (dp + 8) * 2 + 2 * 64 * 72 * 2 + 2 * s_pad * 4 + 512
            + (s_pad * (dp + 8) * 4 if dq_shared else 0))


def _dq_pitch(d, dtype):
    """The row pitch (floats) of K2's fp32 dQ accumulator."""
    return _dim_pad(d) + (4 if dtype == torch.float32 else 8)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _key_groups(bh, s, sms):
    """Blocks per (b, h) of the fp32 K2: its key tiles split into equal
    groups, the fewest that let B*H*groups fill the two block slots of
    every SM (B=8, S=512, H=12 has 96 (b, h) pairs for 264 slots: 4 groups
    of 2 key tiles); each group adds its own dQ, summed in group order
    after. ``chip_smoke.py k2-groups`` times every split."""
    tiles = -(-s // 64)
    for groups in range(1, tiles + 1):
        if tiles % groups == 0 and bh * groups >= 2 * sms:
            return groups
    return tiles


def _tc_aligned(t):
    """The kernels stage rows by 16-byte cp.async: the base pointer and
    every stride must be multiples of 16 bytes (8 bf16 or 4 fp32
    elements)."""
    n = 16 // t.element_size()
    return not (t.data_ptr() % 16 or any(st % n for st in t.stride()[:3]))


def _check_tc_layout(*ts, names="q/k/v"):
    for t in ts:
        if not _tc_aligned(t):  # no fallback
            raise ValueError(
                f"{names}: the bf16 kernels need 16-byte aligned bases and "
                f"strides that are multiples of 8 elements, got strides "
                f"{t.stride()} at offset {t.storage_offset()}")


def _staged(t):
    """An fp32 view the kernels can stage: ``t`` itself when its base and
    strides are 16-byte aligned, else a contiguous copy."""
    return t if _tc_aligned(t) else t.contiguous()


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
            out_lo=None, lse_lo=None, row_base: int = 0, heads_total=None,
            head0: int = 0):
    """K1: dropout(softmax(QK^T/sqrt(D) + bias)) V through the CUDA kernel.

    Takes the layout of ``multi_head_attention``. Both dtypes run a
    tensor-core kernel, which fills ``lse`` (a float32 [B, H, S] buffer:
    the row log-sum-exp) when given. bf16 (q/k/v 16-byte aligned with
    strides in multiples of 8, else ``ValueError``) also fills ``out_lo``
    (a contiguous bf16 [B, S, H, D] buffer: the output's remainder,
    out + out_lo = the fp32 output to ~2**-16) when given; fp32 (the TF32
    kernel, three passes a product) takes no ``out_lo`` but fills
    ``lse_lo`` (a float32 [B, H, S] buffer: the LSE's remainder, lse +
    lse_lo = the row log-sum-exp to ~2**-48, which the fp32 K2 needs on
    rows whose keys are all padding) when given with ``lse``, and copies a
    view whose base or strides are not multiples of 16 bytes. A CPU input
    takes the plain version; a CUDA input launches a kernel or raises —
    there is no fallback. ``mha_fwd.launches`` counts the launches. Rate 0
    draws no bits; the mask is drawn at ``row_base`` for heads ``head0``...
    of ``heads_total`` (module docstring)."""
    _check(q, k, v, bias)
    heads_total = _check_dropout(rate, seed, row_base, q.shape[2],
                                 heads_total, head0)
    hk = dict(row_base=row_base, heads_total=heads_total, head0=head0)
    if lse is not None:
        _check_lse(lse, q)
    if out_lo is not None:
        _check_like(out_lo, q, "out_lo", torch.bfloat16)
    if lse_lo is not None:
        if lse is None:
            raise ValueError("lse_lo comes with lse")
        _check_lse(lse_lo, q)
    if q.device.type == "cpu":
        if lse is None and out_lo is None:
            return _mha_torch(q, k, v, bias, rate, seed, **hk)
        out, plain_lse = _mha_torch(q, k, v, bias, rate, seed,
                                    return_lse=True, **hk)
        if lse is not None:
            lse.copy_(plain_lse)
        if lse_lo is not None:
            exact = _mha_torch(*(t.double() for t in (q, k, v, bias)),
                               return_lse=True)[1]
            lse_lo.copy_(exact - plain_lse.double())
        if out_lo is not None:
            full = _mha_torch(q.float(), k.float(), v.float(), bias, rate,
                              seed, **hk)
            out_lo.copy_(full - out.float())
        return out
    if q.device.type != "cuda":
        raise ValueError(f"mha_fwd runs on cuda or cpu, not {q.device}")
    if q.dtype == torch.bfloat16:
        _check_tc_layout(q, k, v)
        if out_lo is not None and not out_lo.is_contiguous():
            raise ValueError("out_lo must be contiguous")
        if lse_lo is not None:
            raise ValueError("the bf16 kernel writes no LSE remainder")
    elif out_lo is not None:
        raise ValueError("the fp32 kernel writes no output remainder")
    else:
        q, k, v = _staged(q), _staged(k), _staged(v)
    b, s, h, d = q.shape
    fn = _kernels.load("mha_fwd").uniter_mha_fwd
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    thr = threshold(rate) if rate > 0.0 else 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), _ptr(out_lo), _ptr(lse), _ptr(lse_lo),
                b, s, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                1.0 / math.sqrt(d), thr, 1.0 / (1.0 - rate), int(seed),
                int(row_base), heads_total, int(head0), _DTYPE_CODE[q.dtype],
                stream)
    if rc:
        raise RuntimeError(f"mha_fwd kernel launch failed: cudaError_t {rc} "
                           f"at q{tuple(q.shape)} {q.dtype}")
    mha_fwd.launches += 1
    return out


mha_fwd.launches = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def mha_bwd(q, k, v, bias, g, rate: float = 0.0, seed: int = 0, out=None,
            lse=None, out_lo=None, lse_lo=None, row_base: int = 0,
            heads_total=None, head0: int = 0):
    """K2: dq, dk, dv of ``mha_fwd`` (same rate and seed) for the output
    gradient ``g`` [B, S, H, D]. Results are contiguous [B, S, H, D] in q's
    dtype. Both dtypes run a one-pass tensor-core kernel from the forward's
    ``out`` and ``lse`` (bf16 also ``out_lo``, fp32 also ``lse_lo``), and
    raise without them; the fp32 kernel (TF32, three passes a product)
    copies a view it cannot stage. A CPU input takes ``_mha_bwd_lse_torch``
    when given out and lse (the output as out + out_lo when out_lo is
    given, with lse_lo when given), else ``_mha_bwd_torch``.
    ``mha_bwd.launches`` counts the kernel calls (one per call). The mask is
    replayed at ``row_base``, ``heads_total`` and ``head0``, as ``mha_fwd``
    drew it."""
    _check(q, k, v, bias, "mha_bwd")
    heads_total = _check_dropout(rate, seed, row_base, q.shape[2],
                                 heads_total, head0)
    hk = dict(row_base=row_base, heads_total=heads_total, head0=head0)
    _check_like(g, q, "g")
    if (out is None) != (lse is None):
        raise ValueError("mha_bwd takes the forward's out and lse together")
    if out is not None:
        _check_like(out, q, "out")
        _check_lse(lse, q)
    if out_lo is not None:
        _check_like(out_lo, q, "out_lo", torch.bfloat16)
    if lse_lo is not None:
        if lse is None:
            raise ValueError("lse_lo comes with lse")
        _check_lse(lse_lo, q)
    if g.stride(-1) != 1:
        g = g.contiguous()
    if q.device.type == "cpu":
        if out is None:
            return _mha_bwd_torch(q, k, v, bias, g, rate, seed, **hk)
        if out_lo is not None:
            out = out.float() + out_lo.float()
        return _mha_bwd_lse_torch(q, k, v, bias, g, out, lse, rate, seed,
                                  lse_lo, **hk)
    if q.device.type != "cuda":
        raise ValueError(f"mha_bwd runs on cuda or cpu, not {q.device}")
    b, s, h, d = q.shape
    if q.dtype == torch.bfloat16:
        if out is None or out_lo is None or lse_lo is not None:
            raise ValueError("the bf16 kernel needs the forward's out, lse "
                             "and out_lo, and no lse_lo")
        _check_tc_layout(q, k, v)
        if not _tc_aligned(g):
            g = g.contiguous()
        out, out_lo = out.contiguous(), out_lo.contiguous()
        _check_tc_layout(out, out_lo, names="out/out_lo")
    elif out is None or lse_lo is None:
        raise ValueError("the fp32 kernel needs the forward's out, lse and "
                         "lse_lo")
    elif out_lo is not None:
        raise ValueError("the fp32 kernel takes no output remainder")
    else:
        q, k, v, g = (_staged(t) for t in (q, k, v, g))
        out = out.contiguous()
    scratch, groups = None, 1
    if q.dtype == torch.float32:
        groups = _key_groups(b * h, s, _sm_count(q.device.index))
    if q.dtype == torch.float32 or _bwd_smem(s, d, q.dtype) > SMEM_LIMIT:
        # dQ in device memory
        scratch = torch.empty((groups, b * h, -(-s // 64) * 64,
                               _dq_pitch(d, q.dtype)),
                              dtype=torch.float32, device=q.device)
    fn = _kernels.load("mha_bwd").uniter_mha_bwd
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    thr = threshold(rate) if rate > 0.0 else 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                bias.data_ptr(), _ptr(out), _ptr(out_lo), _ptr(lse),
                _ptr(lse_lo), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                _ptr(scratch), b, s, h, d, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *g.stride()[:3], 1.0 / math.sqrt(d), thr,
                1.0 / (1.0 - rate), int(seed), int(row_base), heads_total,
                int(head0), _DTYPE_CODE[q.dtype], groups, stream)
    if rc:
        raise RuntimeError(f"mha_bwd kernel launch failed: cudaError_t {rc} "
                           f"at q{tuple(q.shape)} {q.dtype}")
    mha_bwd.launches += 1
    return dq, dk, dv


mha_bwd.launches = 0


class MhaFunction(torch.autograd.Function):
    """K1 forward, K2 backward. Saves q, k, v, bias and the seed, as the JAX
    package's ``_mha_pallas_fwd`` saves them, and what the one-pass K2 reads
    besides: the output, K1's [B, H, S] fp32 LSE and, in fp32, the LSE's
    fp32 remainder ``lse_lo``, in bf16 the output's bf16 remainder
    ``out_lo`` (at B=96, S=104, H=12: 0.48 MB a layer for each [B, H, S]
    buffer, 15.3 MB for out_lo; the output's own storage is the one the
    output projection saves anyway). The bias gets no gradient (it comes
    from ``attn_mask``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, rate, seed, row_base=0, heads_total=None,
                head0=0):
        _check_seq(q.shape[1], "mha_bwd")  # before any work
        ctx.rate, ctx.seed = rate, seed
        ctx.hk = dict(row_base=row_base, heads_total=heads_total,
                      head0=head0)
        b, s, h, _ = q.shape
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        if q.dtype == torch.bfloat16:
            lo = torch.empty_like(q, memory_format=torch.contiguous_format)
            out = mha_fwd(q, k, v, bias, rate, seed, lse=lse, out_lo=lo,
                          **ctx.hk)
        else:
            lo = torch.empty_like(lse)
            out = mha_fwd(q, k, v, bias, rate, seed, lse=lse, lse_lo=lo,
                          **ctx.hk)
        ctx.save_for_backward(q, k, v, bias, out, lse, lo)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse, lo = ctx.saved_tensors
        key = "out_lo" if q.dtype == torch.bfloat16 else "lse_lo"
        dq, dk, dv = mha_bwd(q, k, v, bias, g, ctx.rate, ctx.seed, out=out,
                             lse=lse, **ctx.hk, **{key: lo})
        return dq, dk, dv, None, None, None, None, None, None


def multi_head_attention(q, k, v, bias, *, impl: str = "xla",
                         dropout_rate: float = 0.0,
                         deterministic: bool = True,
                         seed: int = None, row_base: int = 0,
                         heads_total=None, head0: int = 0):
    """Fused MHA. q, k, v: [B, S, H, D]; bias: [B, S] additive (0 / -10000).

    ``impl="cuda"`` takes the kernels (``MhaFunction``: K1 forward, K2
    backward), ``"xla"`` the plain version under autograd. Dropout on P is
    live when ``deterministic`` is False and the rate positive; it then
    needs the call's ``seed`` (``ops.dropout.draw_seed``) and draws its
    mask at ``row_base`` for heads ``head0``... of ``heads_total`` (module
    docstring). Returns [B, S, H, D]."""
    hk = dict(row_base=row_base, heads_total=heads_total, head0=head0)
    rate = 0.0 if deterministic else float(dropout_rate)
    if rate > 0.0 and seed is None:
        raise ValueError("live attention dropout needs a seed")
    seed = int(seed or 0) if rate > 0.0 else 0
    if impl == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return MhaFunction.apply(q, k, v, bias.float(), rate, seed,
                                     row_base, heads_total, head0)
        # no backward to feed: K1 alone, writing no LSE or remainder
        return mha_fwd(q, k, v, bias.float(), rate, seed, **hk)
    if impl == "xla":
        return _mha_torch(q, k, v, bias, rate, seed, **hk)
    raise ValueError(f"unknown attention impl {impl!r}")
