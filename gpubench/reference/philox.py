"""Dropout masks and seeds as the port draws them, worked out again.

A frozen copy of the rule, not an import: Philox4x32-10 on int64 tensors,
an element kept iff its u32 word is >= floor(rate * 2**32); element (r, c)
of a tensor viewed as [rows, cols] takes word c % 4 of the counter
(c // 4, lo32(r), hi32(r), 0) under the key (lo32(seed), hi32(seed)).
An attention mask over scores (b, h, q, k) is element k of row
(b * H + h) * S + q of a [B, H, S, S] tensor.

A train step's dropout seeds come from a CPU ``torch.Generator`` seeded
from ``SeedSequence([run seed, step])``, one ``randint(2**31 - 1)`` a live
call, in the order the forward makes them: the text embeddings' tail, the
image embeddings' tail, then per layer the attention probabilities, the
attention tail and the FFN tail.
"""

from __future__ import annotations

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
SEED_MAX = 2**31 - 1


def _mulhilo(a: int, b: torch.Tensor):
    p1 = b * (a & 0xFFFF)
    p2 = b * (a >> 16)
    t = p1 + ((p2 & 0xFFFF) << 16)
    return (p2 >> 16) + (t >> 32), t & _MASK32


def _philox(c0, c1, c2, c3, k0: int, k1: int):
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(seed: int, shape, rate: float, device=None) -> torch.Tensor:
    """Boolean keep mask of ``shape`` (True with probability 1 - rate)."""
    shape = tuple(int(n) for n in shape)
    cols = shape[-1]
    rows = int(np.prod(shape[:-1]))
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c4 = torch.arange((cols + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = _philox(c4[None, :], r & _MASK32, r >> 32, zero,
                    int(seed) & _MASK32, (int(seed) >> 32) & _MASK32)
    thr = int(rate * 2**32)
    return torch.stack([w >= thr for w in words], dim=-1).reshape(
        rows, -1)[:, :cols].reshape(shape)


class StepSeeds:
    """The dropout seeds of one optimizer step, drawn in call order."""

    def __init__(self, run_seed: int, step: int):
        mixed = np.random.SeedSequence([int(run_seed), int(step)])
        self.gen = torch.Generator()
        self.gen.manual_seed(int(mixed.generate_state(1)[0]))

    def next(self) -> int:
        return int(torch.randint(SEED_MAX, (1,), generator=self.gen))
