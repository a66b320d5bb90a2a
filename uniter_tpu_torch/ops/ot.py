"""Optimal transport (IPOT) for the word-region alignment pretraining loss:
the plain torch version and the K7 kernel.

Counterpart of ``uniter_tpu/ops/ot.py`` (reference model/ot.py). The
reference runs 50 proximal-point iterations (k = 1 inner Sinkhorn steps)
under ``torch.no_grad`` on a detached cost matrix, then takes distance =
trace(C @ T) with T detached: gradients flow through the cosine cost matrix
only. Everything runs in fp32 (reference model/pretrain.py:186-188).

``ipot`` is the plain version, a Python loop of ``iteration`` x ``k`` steps
on [B, N, M] tensors, and K7's oracle. ``ipot_cuda`` takes the same
arguments and gives the same plan through one launch of the hand-written
kernel (``csrc/ipot.cu``, the counterpart of the whole of ``ipot_pallas``:
the preparation, the loop and the final re-mask); a CPU input takes
``ipot``, a CUDA input launches the kernel or raises;
``ipot_cuda.launches`` counts the launches. ``optimal_transport_dist(...,
impl=)`` picks between them from its argument alone: ``"cuda"`` or
``"xla"`` (the drivers resolve it from ``--device``).
"""

from __future__ import annotations

import torch

from uniter_tpu_torch.ops import _kernels

# the most dynamic shared memory a block may opt into on an H100
SMEM_LIMIT = 232448
# the kernel's warps a block (its [16, M] column partials) and the largest
# plan its register form holds (csrc/ipot.cu)
WARPS = 16
REG_MAX_N, REG_MAX_M = 128, 160


def cost_matrix_cosine(x, y, eps: float = 1e-5):
    """Batched pairwise cosine distance [B,M,D],[B,N,D] -> [B,M,N]
    (reference ot.py:11-21; F.normalize clamps the norm at eps)."""
    xn = x / x.norm(dim=-1, keepdim=True).clamp_min(eps)
    yn = y / y.norm(dim=-1, keepdim=True).clamp_min(eps)
    return 1.0 - torch.einsum("bmd,bnd->bmn", xn, yn)


def _ipot_inputs(C, x_len, x_pad, y_len, y_pad, joint_pad, beta):
    """The kernel's inputs, elementwise from the cost: A = exp(-C^T / beta)
    zeroed at joint padding [B, N, M], sigma0 and x_mask [B, M], y_mask
    [B, N], the lengths clamped to >= 1 (all-padding examples stay finite)
    [B], and the transposed joint padding."""
    x_len = x_len.float().clamp_min(1.0)
    y_len = y_len.float().clamp_min(1.0)
    jp_t = joint_pad.transpose(1, 2)
    zero = torch.zeros((), dtype=torch.float32, device=C.device)
    A = torch.where(jp_t, zero, torch.exp(-C.float().transpose(1, 2) / beta))
    sigma0 = torch.where(x_pad, zero, 1.0 / x_len[:, None])
    x_mask = x_pad.float() * 1e4
    y_mask = y_pad.float() * 1e4
    return A, sigma0, x_mask, y_mask, x_len, y_len, jp_t


def ipot(C, x_len, x_pad, y_len, y_pad, joint_pad, beta, iteration, k):
    """Inexact proximal point OT (reference ot.py:35-66), the plain version.

    C: [B, M, N] cost; x_pad/y_pad True at padding; x_len/y_len valid counts.
    Returns the transport plan T [B, N, M] (the reference's transposed
    layout), zero at joint padding."""
    A, sigma, x_mask, y_mask, x_len, y_len, jp_t = _ipot_inputs(
        C, x_len, x_pad, y_len, y_pad, joint_pad, beta)
    T = (~jp_t).float()
    xl, yl = x_len[:, None], y_len[:, None]
    for _ in range(iteration):
        Q = A * T  # [B, N, M]
        for _ in range(k):
            delta = 1.0 / (yl * torch.einsum("bnm,bm->bn", Q, sigma) + y_mask)
            sigma = 1.0 / (xl * torch.einsum("bn,bnm->bm", delta, Q) + x_mask)
        T = delta[:, :, None] * Q * sigma[:, None, :]
    return torch.where(jp_t, torch.zeros((), device=C.device), T)


def ipot_form(n: int, m: int) -> int:
    """Which form of the kernel a [N, M] plan takes: 0 keeps A and Q in
    registers (N up to 128 regions, M up to 160 text tokens: every bucket
    of pretraining); 1 keeps Q in shared memory (4 (N M' + 2 (N + M))
    bytes within the block's limit, M' = M rounded up to 32: N M up to
    about 57,000 elements) and A in a workspace in device memory; 2 keeps Q
    in the output buffer as well. Raises for a shape whose vectors alone do
    not fit."""
    if n <= REG_MAX_N and m <= REG_MAX_M:
        return 0
    vecs = 2 * (n + m)
    if 4 * (n * -(-m // 32) * 32 + vecs) <= SMEM_LIMIT:
        return 1
    if 4 * vecs <= SMEM_LIMIT:
        return 2
    raise ValueError(f"ipot_cuda: a [{n}, {m}] plan does not fit the kernel "
                     f"(its vectors alone exceed {SMEM_LIMIT} bytes of "
                     f"shared memory)")


def _fits(C, x_len, x_pad, y_len, y_pad, joint_pad, iteration, k):
    """One look at each input: True when a launch takes them as they are
    (C fp32 [B, M, N], the lengths fp32 [B], the pads bool, all contiguous
    on C's device, k >= 1). False sends the wrapper to ``_check``, which
    raises on what is wrong, and to ``_card_inputs``, which fixes the
    rest."""
    if C.dtype != torch.float32 or C.dim() != 3 or not C.is_contiguous():
        return False
    b, m, n = C.shape
    dev = C.device
    for t, shape, dtype in ((x_len, (b,), torch.float32),
                            (y_len, (b,), torch.float32),
                            (x_pad, (b, m), torch.bool),
                            (y_pad, (b, n), torch.bool),
                            (joint_pad, (b, m, n), torch.bool)):
        if (t.device != dev or t.dtype != dtype or t.shape != shape
                or not t.is_contiguous()):
            return False
    return b > 0 and m > 0 and n > 0 and iteration >= 0 and k >= 1


def _check(C, x_len, x_pad, y_len, y_pad, joint_pad, iteration, k):
    """The rules every input obeys, on any device: C floating [B, M, N],
    the lengths [B], the pads bool [B, M], [B, N], [B, M, N], all on C's
    device, iteration >= 0, k >= 1."""
    if C.dim() != 3:
        raise ValueError(f"ipot_cuda: C must be [B, M, N], got "
                         f"{tuple(C.shape)}")
    b, m, n = C.shape
    want = {"x_len": (b,), "y_len": (b,), "x_pad": (b, m), "y_pad": (b, n),
            "joint_pad": (b, m, n)}
    got = dict(x_len=x_len, y_len=y_len, x_pad=x_pad, y_pad=y_pad,
               joint_pad=joint_pad)
    for name, shape in want.items():
        t = got[name]
        if tuple(t.shape) != shape or t.device != C.device:
            raise ValueError(f"ipot_cuda: {name} must be {shape} on "
                             f"{C.device}, got {tuple(t.shape)} on {t.device}")
        if name.endswith("pad") and t.dtype != torch.bool:
            raise TypeError(f"ipot_cuda: {name} must be bool, got {t.dtype}")
    if not C.is_floating_point():
        raise TypeError(f"ipot_cuda: C must be floating point, got {C.dtype}")
    if int(iteration) < 0 or int(k) < 1 or b < 1 or m < 1 or n < 1:
        raise ValueError(f"ipot_cuda: needs iteration >= 0, k >= 1 and a "
                         f"non-empty [B, M, N] cost, got iteration "
                         f"{iteration}, k {k}, C {tuple(C.shape)}")
    if C.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ipot_cuda runs on cuda or cpu, not {C.device}")


def _card_inputs(C, x_len, x_pad, y_len, y_pad, joint_pad):
    """What ``_check`` passed, as the kernel takes it: C and the lengths
    cast to fp32, every input contiguous."""
    return (C.float().contiguous(), x_len.float().contiguous(),
            x_pad.contiguous(), y_len.float().contiguous(),
            y_pad.contiguous(), joint_pad.contiguous())


def ipot_cuda(C, x_len, x_pad, y_len, y_pad, joint_pad, beta, iteration=50,
              k=1):
    """K7: ``ipot`` through the CUDA kernel, all of it in one launch: the
    lengths' clamp, A, sigma0 and the masks, the loop and the zeros at
    joint padding. Same arguments, same [B, N, M] plan. A CPU input takes
    ``ipot``; a CUDA input launches the kernel or raises. The launch path
    is K8's: one look at each input (a non-fp32 C or length is cast and a
    strided input copied, after the full checks), the entry point resolved
    once, the raw handle of the card's current stream, one packed argument
    block, the device switch in C."""
    if not (C.is_cuda and _fits(C, x_len, x_pad, y_len, y_pad, joint_pad,
                                iteration, k)):
        _check(C, x_len, x_pad, y_len, y_pad, joint_pad, iteration, k)
        if C.device.type == "cpu":
            return ipot(C, x_len, x_pad, y_len, y_pad, joint_pad, beta,
                        iteration, k)
        C, x_len, x_pad, y_len, y_pad, joint_pad = _card_inputs(
            C, x_len, x_pad, y_len, y_pad, joint_pad)
    b, m, n = C.shape
    form = ipot_form(n, m)
    T = torch.empty((b, n, m), dtype=torch.float32, device=C.device)
    # forms 1 and 2: the warp partials of the column sums, and A
    ws = None if form == 0 else torch.empty(
        b * (WARPS + n) * m, dtype=torch.float32, device=C.device)
    idx = C.device.index
    rc = _kernels.entry("ipot")(_kernels.IPOT_CALL.pack(
        C.data_ptr(), x_len.data_ptr(), y_len.data_ptr(), x_pad.data_ptr(),
        y_pad.data_ptr(), joint_pad.data_ptr(), T.data_ptr(),
        0 if ws is None else ws.data_ptr(), b, n, m, int(iteration), int(k),
        form, float(beta), idx, torch._C._cuda_getCurrentRawStream(idx)))
    if rc:
        raise RuntimeError(f"ipot kernel launch failed: cudaError_t {rc} at "
                           f"B={b}, N={n}, M={m} (form {form})")
    ipot_cuda.launches += 1
    return T


ipot_cuda.launches = 0


def optimal_transport_dist(txt_emb, img_emb, txt_pad, img_pad, beta=0.5,
                           iteration=50, k=1, impl: str = "xla"):
    """Per-example OT distance [B] (reference ot.py:69-85).

    ``impl``: "xla" (the plain loop) or "cuda" (K7, one launch). The plan is
    computed without gradient on a detached cost; the distance
    ``sum_mn C[m, n] T[n, m]`` lets gradients flow through the cost only."""
    if impl not in ("xla", "cuda"):
        raise ValueError(f"unknown ot impl {impl!r}")
    cost = cost_matrix_cosine(txt_emb.float(), img_emb.float())
    joint_pad = txt_pad[:, :, None] | img_pad[:, None, :]
    cost = cost.masked_fill(joint_pad, 0.0)
    txt_len = (~txt_pad).sum(1).to(cost.dtype)
    img_len = (~img_pad).sum(1).to(cost.dtype)
    ipot_fn = ipot_cuda if impl == "cuda" else ipot
    with torch.no_grad():
        T = ipot_fn(cost.detach(), txt_len, txt_pad, img_len, img_pad,
                    joint_pad, beta, iteration, k)
    # trace(C @ T) per batch element = sum_mn C[m,n] * T[n,m]
    return torch.einsum("bmn,bnm->b", cost, T)
