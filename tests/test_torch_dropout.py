"""The port's dropout masks (``uniter_tpu_torch.ops.dropout``) on the CPU.

Philox4x32-10 in plain torch (int64 tensors, 16-bit limbs) must equal the
Random123 known-answer vectors and an independent numpy-uint64 version
written here, word for word; the mask of an element is a function of its
(row, column) and the seed alone; the keep fraction at rate 0.1 over 10**6
draws lies within 4 sigma of 0.9; dropout scales kept values by 1/(1-rate)
and zeroes the rest, and rate 0 or a deterministic call is the identity.
The rule matches the JAX package's (keep iff u32 >= rate * 2**32); its
bits do not, as ROADMAP.md ("Dropout") records.
"""

import numpy as np
import pytest
import torch

from uniter_tpu_torch.ops import dropout as D

torch.set_num_threads(2)

U32 = np.uint64(0xFFFFFFFF)


def _np_philox(ctr, key):
    """Philox4x32-10 on numpy uint64 arrays (the products fit in 64 bits)."""
    c = [np.asarray(x, np.uint64) for x in ctr]
    k0, k1 = (np.uint64(x) for x in key)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & U32
            k1 = (k1 + np.uint64(0xBB67AE85)) & U32
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & U32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & U32]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    got = D.philox4x32_10(*(torch.tensor([c], dtype=torch.int64)
                            for c in ctr), *key)
    assert [int(w) for w in got] == list(want)
    assert [int(w) for w in _np_philox(ctr, key)] == list(want)


def test_philox_matches_numpy_on_random_counters():
    rng = np.random.RandomState(0)
    ctr = rng.randint(0, 2**32, size=(4, 5000), dtype=np.uint64)
    key = tuple(int(x) for x in rng.randint(0, 2**32, size=2,
                                            dtype=np.uint64))
    got = D.philox4x32_10(*(torch.from_numpy(c.astype(np.int64))
                            for c in ctr), *key)
    want = _np_philox(ctr, key)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.uint64), w)


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4, 9), (1, 1)])
def test_random_bits_follow_the_counter_rule(shape):
    """Element (r, c) of the [rows, cols] view takes word c % 4 of counter
    (c // 4, lo32(r), hi32(r), offset) under key (lo32(seed), hi32(seed))."""
    seed, offset = (3 << 32) + 12345, 7
    bits = D.random_bits(seed, offset, shape).reshape(-1, shape[-1]).numpy()
    rows, cols = bits.shape
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    r, c = r.astype(np.uint64), c.astype(np.uint64)
    words = _np_philox((c // np.uint64(4), r & U32, r >> np.uint64(32),
                        np.full_like(r, offset)),
                       (seed & 0xFFFFFFFF, seed >> 32))
    want = np.choose((c % np.uint64(4)).astype(np.int64), words)
    assert np.array_equal(bits.astype(np.uint64), want)


def test_mask_replays_and_depends_on_seed_and_offset():
    shape, rate = (4, 6, 33), 0.3
    m = D.keep_mask(11, 0, shape, rate)
    assert torch.equal(m, D.keep_mask(11, 0, shape, rate))
    assert not torch.equal(m, D.keep_mask(12, 0, shape, rate))
    assert not torch.equal(m, D.keep_mask(11, 1, shape, rate))
    # a row's bits do not depend on how many rows the tensor has
    assert torch.equal(D.keep_mask(11, 0, (2, 6, 33), rate),
                       m[:2])


def test_keep_fraction_within_four_sigma():
    n, rate = 10**6, 0.1
    frac = D.keep_mask(2024, 0, (1000, 1000), rate).float().mean().item()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(frac - (1 - rate)) <= 4 * sigma


def test_dropout_scales_kept_values():
    x = torch.randn(8, 40, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    y = D.dropout(x, 0.25, deterministic=False, generator=gen)
    seed = D.draw_seed(torch.Generator().manual_seed(0))
    keep = D.keep_mask(seed, 0, x.shape, 0.25)
    assert torch.equal(y, torch.where(keep, x / 0.75, torch.zeros(())))
    assert D.dropout(x, 0.25) is x
    assert D.dropout(x, 0.0, deterministic=False) is x
    with pytest.raises(ValueError):
        D.dropout(x, 0.25, deterministic=False)
