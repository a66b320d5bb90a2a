"""Dropout with counter-based Philox4x32-10 masks.

Counterpart of ``uniter_tpu/ops/dropout.py``. The rule is the JAX package's
(``uniter_tpu/ops/attention.py:86-94``, ``ops/fused_block.py:38-43``): an
element is kept iff its u32 draw is >= floor(rate * 2**32), and kept values
scale by 1 / (1 - rate). The generator differs: the TPU kernels draw from
the on-core PRNG and the XLA path from ``jax.random.bernoulli``, neither of
which a GPU reproduces, so masks here come from Philox4x32-10 and match
the JAX package in rate and rule, not bit for bit.

The bit of an element is a function of its coordinates and the call's seed
alone. View the tensor as ``[rows, cols]`` (``cols`` the last dimension);
drawn at row base ``r0`` (a 64-bit int, 0 by default), element (r, c)
takes word ``c % 4`` of Philox4x32-10 with

    key     = (lo32(seed), hi32(seed))
    counter = (c // 4, lo32(r0 + r), hi32(r0 + r), offset)

so a tensor drawn at ``r0`` gets, bit for bit, rows ``r0...`` of the mask
of a larger tensor drawn at 0. That is how data parallelism keeps one
process's masks: rank p holds the p-th of N equal blocks of the global
batch (``data/loader.py``), so each of its tensors is block p of the
global tensor along the batch axis, and it draws at the row base
``p * rows`` (``rows_before``) from the one process's seeds. The
attention kernels (``csrc/mha_fwd.cu``, ``csrc/mha_bwd.cu``) draw the
mask of score (b, h, q, k) as element (k) of row
r0 + ((b*H_total + h0 + h)*S + q) of a ``[B, H_total, S, S]`` tensor by
the same formula (``H_total`` the model's heads, ``h0`` the first of the
launch's: a tensor-parallel rank holds heads h0... of each example, rows
that are not one block), so the plain versions, the forward and the
backward all see the same bits, whatever their tiling.

Plain torch has no unsigned 32-bit multiply, and a 32x32 -> 64-bit product
overflows int64; ``_mulhilo`` splits the constant factor into 16-bit limbs
(in Python, so the tensor side takes two products) and every intermediate
stays below 2**49. The arithmetic runs on int64 tensors on the input's
device (CPU or card).

Masks are never stored by the kernels; ``dropout`` here is the plain
composition (autograd keeps its boolean mask for the backward).

``impl`` "u16" and "u8" are the JAX package's reduced-bit rules
(``uniter_tpu/ops/dropout.py:29-57``): the threshold is
``round(rate * 65536)`` (``round(rate * 256)``), an element is kept iff its
bits are >= it, and kept values scale by ``1 / (1 - thr / 65536)``
(``/ 256``), the quantized keep rate, so E[dropout(x)] = x exactly; a rate
whose threshold rounds to 0 or to the maximum takes the 32-bit rule. The
JAX package draws those bits with ``jax.random.bits`` of 16 (8) bits; here
they are the top 16 (8) bits of the element's Philox word above, a choice
of the port (no generator reproduces JAX's bits, as with the 32-bit rule).
Only the plain dropouts of the encoder's tails follow ``impl``, as in the
JAX package (``uniter_tpu/models/encoder.py:68,97``): the kernels K1-K6
keep the 32-bit rule, as the Pallas kernels ignore ``dropout_impl``
(:63-69,92-98), and the heads' dropouts are flax ``nn.Dropout`` there
(32-bit, ``models/heads.py:104``, ``models/nlvr2.py:94``).
"""

from __future__ import annotations

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF
SEED_MAX = 2**31 - 1  # seeds are drawn in [0, SEED_MAX)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi32, lo32) of the 64-bit product of the u32 constant ``a`` and the
    u32 values ``b`` (int64 tensor), without overflowing int64."""
    p1 = b * (a & 0xFFFF)  # < 2**48
    p2 = b * (a >> 16)     # < 2**48
    t = p1 + ((p2 & 0xFFFF) << 16)
    return (p2 >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding u32 counter words (broadcast
    together); ``k0``/``k1`` the two u32 key words. Returns four int64
    tensors of u32 values."""
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _words(seed: int, offset: int, shape, device, row_base: int = 0,
           rows_at=None):
    """The four Philox words of every counter of ``shape`` drawn at
    ``row_base`` (module docstring), each [rows, ceil(cols / 4)], and the
    shape's cols. ``rows_at`` (int64, one entry per row of ``shape``)
    names each row's mask row instead: rows that are not one block."""
    shape = tuple(int(n) for n in shape)
    cols = shape[-1] if shape else 1
    rows = 1
    for n in shape[:-1]:
        rows *= n
    seed, offset = int(seed), int(offset) & _MASK32
    if rows_at is None:
        r = torch.arange(int(row_base), int(row_base) + rows,
                         dtype=torch.int64, device=device)[:, None]
    else:
        r = rows_at.to(device=device, dtype=torch.int64).reshape(rows, 1)
    c4 = torch.arange((cols + 3) // 4, dtype=torch.int64, device=device)
    words = philox4x32_10(c4[None, :], r & _MASK32, r >> 32,
                          torch.full((), offset, dtype=torch.int64,
                                     device=device),
                          seed & _MASK32, (seed >> 32) & _MASK32)
    return words, rows, cols


def _interleave(words, shape, rows, cols):
    return torch.stack(words, dim=-1).reshape(rows, -1)[:, :cols].reshape(
        shape)


def random_bits(seed: int, offset: int, shape, device=None,
                row_base: int = 0) -> torch.Tensor:
    """u32 draws (as int64) for every element of ``shape`` drawn at
    ``row_base`` by the rule in the module docstring."""
    words, rows, cols = _words(seed, offset, shape, device, row_base)
    return _interleave(words, tuple(shape), rows, cols)


def threshold(rate: float) -> int:
    """The u32 threshold: keep iff bits >= floor(rate * 2**32)."""
    return int(rate * 2**32)


DROPOUT_IMPLS = {"xla": 32, "u16": 16, "u8": 8}  # impl -> bits compared


def mask_rule(rate: float, impl: str = "xla"):
    """(bits, threshold, keep rate) of ``impl`` at ``rate`` (module
    docstring): the top ``bits`` bits of each Philox word are compared
    with the threshold, kept values scale by 1 / keep rate."""
    if impl not in DROPOUT_IMPLS:
        raise ValueError(f"unknown dropout_impl {impl!r}")
    bits = DROPOUT_IMPLS[impl]
    if bits < 32:
        thr = int(round(rate * 2**bits))
        if 0 < thr < 2**bits:
            return bits, thr, 1.0 - thr / 2**bits
    return 32, threshold(rate), 1.0 - rate


def keep_mask(seed: int, offset: int, shape, rate: float,
              device=None, impl: str = "xla",
              row_base: int = 0, rows_at=None) -> torch.Tensor:
    """Boolean keep-mask of ``shape`` drawn at ``row_base`` (or with the
    mask rows ``rows_at``, ``_words``); True with probability 1 - rate
    (the quantized keep rate under ``impl`` "u16"/"u8"). (Each word is
    compared before the four are interleaved, so the interleave moves
    bytes, not int64s.)"""
    words, rows, cols = _words(seed, offset, shape, device, row_base,
                               rows_at)
    bits, thr, _ = mask_rule(rate, impl)
    return _interleave([(w >> (32 - bits) if bits < 32 else w) >= thr
                        for w in words], tuple(shape), rows, cols)


class StepGenerator(torch.Generator):
    """The CPU generator of one train step's draws (``training/step.py``),
    which also knows this rank's place in the global batch: ``block`` p of
    ``blocks`` N equal blocks along the batch axis (0 of 1 in one
    process). Every rank draws the same seeds; the row base of a draw is
    what makes its masks its block of the global ones."""

    block: int = 0
    blocks: int = 1


def batch_block(generator) -> tuple:
    """(block, blocks) of a step's ``generator``: (0, 1) for any other
    generator or None."""
    return (getattr(generator, "block", 0), getattr(generator, "blocks", 1))


def rows_before(block: int, shape) -> int:
    """The row base of a draw over this rank's ``shape`` when it is block
    ``block`` of equal blocks along its first axis: ``block`` times its
    rows (every axis but the last)."""
    rows = 1
    for n in tuple(shape)[:-1]:
        rows *= int(n)
    return int(block) * rows


def draw_seed(generator: torch.Generator) -> int:
    """One call's seed from the step's (CPU) generator."""
    return int(torch.randint(SEED_MAX, (1,), generator=generator))


def live_seed(rate: float, deterministic: bool,
              generator: torch.Generator = None):
    """The seed of a dropout call whose mask is live (not deterministic,
    rate > 0), drawn from ``generator`` (never torch's global one); None
    when the call is the identity."""
    if deterministic or rate == 0.0:
        return None
    if generator is None:
        raise ValueError("live dropout needs a torch.Generator for its seeds")
    return draw_seed(generator)


def drop(x: torch.Tensor, rate: float, seed: int,
         impl: str = "xla", row_base: int = 0) -> torch.Tensor:
    """Inverted dropout of ``x`` with the mask of ``seed`` drawn at
    ``row_base`` (rate > 0) by the rule of ``impl``."""
    bits, _, keep_q = mask_rule(rate, impl)
    keep = keep_mask(seed, 0, x.shape, rate, x.device, impl, row_base)
    if bits == 32:
        kept = x / (1.0 - rate)
    else:  # x * (1 / keep_q) in x's dtype, as the JAX rule scales
        kept = x * torch.tensor(1.0 / keep_q, dtype=x.dtype, device=x.device)
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def dropout(x: torch.Tensor, rate: float, *, deterministic: bool = True,
            generator: torch.Generator = None,
            row_base: int = 0) -> torch.Tensor:
    """Inverted dropout. Identity when deterministic or rate == 0; a live
    call draws its seed from ``generator`` and its mask at ``row_base``."""
    seed = live_seed(rate, deterministic, generator)
    return x if seed is None else drop(x, rate, seed, row_base=row_base)
