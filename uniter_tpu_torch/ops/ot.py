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
kernel (``csrc/ipot.cu``, the counterpart of ``ipot_pallas``); a CPU input
takes ``ipot``, a CUDA input launches the kernel or raises;
``ipot_cuda.launches`` counts the launches. ``optimal_transport_dist(...,
impl=)`` picks between them from its argument alone: ``"cuda"`` or
``"xla"`` (the drivers resolve it from ``--device``).
"""

from __future__ import annotations

import torch

from uniter_tpu_torch.ops import _kernels

# the most dynamic shared memory a block may opt into on an H100
SMEM_LIMIT = 232448


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
    """Which form of the kernel a [N, M] plan takes: 0 keeps A and T in
    shared memory (8 N M + 8 (N + M) bytes within the block's limit: N M up
    to about 28,000 elements), 1 keeps A there and T in its output buffer
    in device memory (N M up to about 57,000), 2 reads A from device memory
    as well. Raises for a shape whose vectors alone do not fit."""
    vecs = 2 * (n + m)
    for form, tiles in ((0, 2), (1, 1), (2, 0)):
        if 4 * (tiles * n * m + vecs) <= SMEM_LIMIT:
            return form
    raise ValueError(f"ipot_cuda: a [{n}, {m}] plan does not fit the kernel "
                     f"(its vectors alone exceed {SMEM_LIMIT} bytes of "
                     f"shared memory)")


def ipot_cuda(C, x_len, x_pad, y_len, y_pad, joint_pad, beta, iteration=50,
              k=1):
    """K7: ``ipot`` through the CUDA kernel, the whole loop of an example in
    one launch. Same arguments, same [B, N, M] plan. The elementwise
    preparation and the final re-mask stay here in plain torch. A CPU input
    takes ``ipot``; a CUDA input launches the kernel or raises."""
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
    if C.device.type == "cpu":
        return ipot(C, x_len, x_pad, y_len, y_pad, joint_pad, beta,
                    iteration, k)
    if C.device.type != "cuda":
        raise ValueError(f"ipot_cuda runs on cuda or cpu, not {C.device}")
    ipot_form(n, m)  # raises for a shape the kernel cannot run
    A, sigma0, x_mask, y_mask, xl, yl, jp_t = (
        t.contiguous() for t in _ipot_inputs(
            C, x_len, x_pad, y_len, y_pad, joint_pad, beta))
    T = _ipot_launch(A, sigma0, x_mask, y_mask, xl, yl, int(iteration),
                     int(k))
    return torch.where(jp_t, torch.zeros((), device=C.device), T)


def _ipot_launch(A, sigma0, x_mask, y_mask, x_len, y_len, iteration, k):
    """One launch of the kernel on its prepared inputs (contiguous fp32 on
    one CUDA device: A [B, N, M], sigma0 and x_mask [B, M], y_mask [B, N],
    the lengths [B]); returns T [B, N, M] before the final re-mask."""
    b, n, m = A.shape
    form = ipot_form(n, m)
    T = torch.empty_like(A)
    fn = _kernels.load("ipot").uniter_ipot
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(A.data_ptr(), sigma0.data_ptr(), x_mask.data_ptr(),
                y_mask.data_ptr(), x_len.data_ptr(), y_len.data_ptr(),
                T.data_ptr(), b, n, m, iteration, k, form, stream)
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
