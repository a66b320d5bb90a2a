"""The port's dropout masks (``uniter_tpu_torch.ops.dropout``) on the CPU.

Philox4x32-10 in plain torch (int64 tensors, 16-bit limbs) must equal the
Random123 known-answer vectors and an independent numpy-uint64 version
written here, word for word; the mask of an element is a function of its
(row, column) and the seed alone; the keep fraction at rate 0.1 over 10**6
draws lies within 4 sigma of 0.9; dropout scales kept values by 1/(1-rate)
and zeroes the rest, and rate 0 or a deterministic call is the identity.
The rule matches the JAX package's (keep iff u32 >= rate * 2**32); its
bits do not, as ROADMAP.md ("Dropout") records.

The row base: a tensor drawn at row base p * rows is, bit for bit, block p
of the tensor of all blocks drawn at 0 (``keep_mask``, ``drop``,
``random_bits``, both bit rules; past 2**32 rows the counter's high word
against numpy), and so are the plain attention (forward, both backward
formulas, the TF32 twins) and the plain fused tails (forward and backward)
of a rank's block of a batch. A tensor-parallel rank's heads: mask rows
named one by one (``rows_at``) are those rows of the whole mask, and the
plain attention of heads h0... of a rank's block (``heads_total``,
``head0``) is that block of the whole call, forward and both backward
formulas.
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


# ---------------------------------------------------------------- row base

@pytest.mark.parametrize("impl", ["xla", "u16"])
@pytest.mark.parametrize("shape", [(3, 7), (2, 5, 9), (2, 3, 4, 6)])
def test_row_base_draws_the_global_block(shape, impl):
    """Block p of N drawn at row base p * rows equals rows p * rows... of
    the N blocks drawn together at 0: the masks, the bits, the dropout."""
    n_blocks, rate, seed = 4, 0.3, (5 << 32) + 77
    glob = (n_blocks * shape[0],) + shape[1:]
    rows = int(np.prod(shape[:-1]))
    mask = D.keep_mask(seed, 0, glob, rate, impl=impl)
    bits = D.random_bits(seed, 3, glob)
    x = torch.randn(glob, dtype=torch.float64)
    y = D.drop(x, rate, seed, impl)
    for p in range(n_blocks):
        blk = slice(p * shape[0], (p + 1) * shape[0])
        base = D.rows_before(p, shape)
        assert base == p * rows
        assert torch.equal(D.keep_mask(seed, 0, shape, rate, impl=impl,
                                       row_base=base), mask[blk])
        assert torch.equal(D.random_bits(seed, 3, shape, row_base=base),
                           bits[blk])
        assert torch.equal(D.drop(x[blk], rate, seed, impl, base), y[blk])


def test_row_base_past_32_bits_follows_the_counter_rule():
    """A row base above 2**32 (a rank's base in a long run) puts the high
    word of the row into the counter, as the kernels read it."""
    seed, base, shape = 99, (3 << 32) + 2**31 + 17, (5, 11)
    bits = D.random_bits(seed, 0, shape, row_base=base).numpy()
    r, c = np.meshgrid(np.arange(5, dtype=np.uint64) + np.uint64(base),
                       np.arange(11, dtype=np.uint64), indexing="ij")
    words = _np_philox((c // np.uint64(4), r & U32, r >> np.uint64(32),
                        np.zeros_like(r)), (seed, 0))
    want = np.choose((c % np.uint64(4)).astype(np.int64), words)
    assert np.array_equal(bits.astype(np.uint64), want)


def test_step_generator_names_the_block():
    """``batch_block`` reads a step generator's block; any other generator
    (or none) is block 0 of 1. The row base of a draw is the block times
    the draw's rows."""
    gen = D.StepGenerator()
    gen.block, gen.blocks = 2, 4
    assert D.batch_block(gen) == (2, 4)
    assert D.batch_block(torch.Generator()) == (0, 1)
    assert D.batch_block(None) == (0, 1)
    assert D.rows_before(3, (4, 5, 6)) == 3 * 4 * 5
    assert D.rows_before(0, (4, 5, 6)) == 0


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_plain_kernels_at_a_row_base_are_the_global_block(n_blocks):
    """The plain attention and the plain fused tails of rank p's block of
    a batch, drawn at the rank's row base (b0*H*S, b0*S), equal block p of
    the whole batch's call at 0: forward, both backward formulas, the
    TF32 twins of the fp32 kernels, and the four tails (float64)."""
    from uniter_tpu_torch.ops import attention as A
    from uniter_tpu_torch.ops import fused_block as F

    rng = np.random.RandomState(n_blocks)
    b, s, h, d, rate, seed = 2, 6, 3, 8, 0.2, 41
    B = n_blocks * b

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape))

    q, k, v, g = t(B, s, h, d), t(B, s, h, d), t(B, s, h, d), t(B, s, h, d)
    bias = torch.zeros(B, s, dtype=torch.float64)
    bias[:, -2:] = -10000.0
    out, lse = A._mha_torch(q, k, v, bias, rate, seed, return_lse=True)
    bwd = A._mha_bwd_torch(q, k, v, bias, g, rate, seed)
    bwd_lse = A._mha_bwd_lse_torch(q, k, v, bias, g, out, lse, rate, seed)
    q32, k32, v32, g32 = (x.float() for x in (q, k, v, g))
    out32 = A._mha_tf32_torch(q32, k32, v32, bias.float(), rate, seed)
    x, res, gy = t(B, s, 16), t(B, s, 16), t(B, s, 16)
    w, bb = 1.0 + 0.1 * t(16), 0.1 * t(16)
    tails = (F._drop_res_ln_torch(x, res, w, bb, rate, seed),
             F._ln_drop_torch(x, w, bb, rate, seed),
             *F._drop_res_ln_bwd_torch(x, res, w, gy, rate, seed)[:2],
             F._ln_drop_bwd_torch(x, w, gy, rate, seed)[0])
    for p in range(n_blocks):
        blk = slice(p * b, (p + 1) * b)
        qa, ka, va, ga, ba = q[blk], k[blk], v[blk], g[blk], bias[blk]
        base = D.rows_before(p, (b, h, s, s))
        assert base == p * b * h * s
        got, got_lse = A._mha_torch(qa, ka, va, ba, rate, seed,
                                    return_lse=True, row_base=base)
        torch.testing.assert_close(got, out[blk], rtol=0, atol=1e-12)
        for a_, w_ in zip(A._mha_bwd_torch(qa, ka, va, ba, ga, rate, seed,
                                           base), (x_[blk] for x_ in bwd)):
            torch.testing.assert_close(a_, w_, rtol=0, atol=1e-12)
        for a_, w_ in zip(A._mha_bwd_lse_torch(
                qa, ka, va, ba, ga, got, got_lse, rate, seed,
                row_base=base), (x_[blk] for x_ in bwd_lse)):
            torch.testing.assert_close(a_, w_, rtol=0, atol=1e-12)
        torch.testing.assert_close(
            A._mha_tf32_torch(q32[blk], k32[blk], v32[blk],
                              bias[blk].float(), rate, seed, row_base=base),
            out32[blk], rtol=0, atol=1e-6)
        torch.testing.assert_close(
            A.multi_head_attention(qa, ka, va, ba, dropout_rate=rate,
                                   deterministic=False, seed=seed,
                                   row_base=base), out[blk], rtol=0,
            atol=1e-12)
        tb = D.rows_before(p, (b, s, 16))
        assert tb == p * b * s
        got_tails = (
            F._drop_res_ln_torch(x[blk], res[blk], w, bb, rate, seed,
                                 row_base=tb),
            F._ln_drop_torch(x[blk], w, bb, rate, seed, row_base=tb),
            *F._drop_res_ln_bwd_torch(x[blk], res[blk], w, gy[blk], rate,
                                      seed, row_base=tb)[:2],
            F._ln_drop_bwd_torch(x[blk], w, gy[blk], rate, seed,
                                 row_base=tb)[0])
        for a_, w_ in zip(got_tails, tails):
            torch.testing.assert_close(a_, w_[blk], rtol=0, atol=1e-12)
    # the base matters: block 1 at base 0 is another mask
    assert not torch.equal(
        A._mha_torch(q[b:2 * b], k[b:2 * b], v[b:2 * b], bias[b:2 * b],
                     rate, seed), out[b:2 * b])


def test_rows_at_draws_the_named_rows():
    """Rows named one by one are, bit for bit, those rows of the mask
    drawn at 0 (both bit rules), whatever their order."""
    whole = D.keep_mask(7, 0, (40, 9), 0.3)
    rows = torch.tensor([33, 2, 17, 17, 39])
    got = D.keep_mask(7, 0, (5, 9), 0.3, rows_at=rows)
    assert torch.equal(got, whole[rows])
    u16 = D.keep_mask(7, 0, (5, 9), 0.3, impl="u16", rows_at=rows)
    assert torch.equal(u16, D.keep_mask(7, 0, (40, 9), 0.3,
                                        impl="u16")[rows])


@pytest.mark.parametrize("n_heads,n_blocks", [(2, 1), (2, 2), (4, 2)])
def test_plain_attention_at_a_head_offset_is_the_head_block(n_heads,
                                                            n_blocks):
    """Heads h0... of rank (p, m)'s block, drawn at (row base b0*H*S,
    heads_total H, head0 h0), equal that block of the whole call: forward,
    both backward formulas, the TF32 forward twin (float64; fp32 for the
    twin)."""
    from uniter_tpu_torch.ops import attention as A

    rng = np.random.RandomState(n_heads * 10 + n_blocks)
    b, s, hh, d, rate, seed = 2, 6, 4, 8, 0.2, 43
    B, h = n_blocks * b, hh // n_heads

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape))

    q, k, v, g = (t(B, s, hh, d) for _ in range(4))
    bias = torch.zeros(B, s, dtype=torch.float64)
    bias[:, -2:] = -10000.0
    out, lse = A._mha_torch(q, k, v, bias, rate, seed, return_lse=True)
    bwd = A._mha_bwd_torch(q, k, v, bias, g, rate, seed)
    bwd_lse = A._mha_bwd_lse_torch(q, k, v, bias, g, out, lse, rate, seed)
    out32 = A._mha_tf32_torch(*(x.float() for x in (q, k, v, bias)), rate,
                              seed)
    for p in range(n_blocks):
        for m in range(n_heads):
            blk = (slice(p * b, (p + 1) * b), slice(None),
                   slice(m * h, (m + 1) * h))
            hk = dict(row_base=D.rows_before(p, (b, hh, s, s)),
                      heads_total=hh, head0=m * h)
            qa, ka, va, ga = (x[blk] for x in (q, k, v, g))
            ba = bias[blk[0]]
            got, got_lse = A._mha_torch(qa, ka, va, ba, rate, seed,
                                        return_lse=True, **hk)
            torch.testing.assert_close(got, out[blk], rtol=0, atol=1e-12)
            for a_, w_ in zip(A._mha_bwd_torch(qa, ka, va, ba, ga, rate,
                                               seed, **hk),
                              (x_[blk] for x_ in bwd)):
                torch.testing.assert_close(a_, w_, rtol=0, atol=1e-12)
            for a_, w_ in zip(A._mha_bwd_lse_torch(
                    qa, ka, va, ba, ga, got, got_lse, rate, seed, **hk),
                    (x_[blk] for x_ in bwd_lse)):
                torch.testing.assert_close(a_, w_, rtol=0, atol=1e-12)
            torch.testing.assert_close(
                A._mha_tf32_torch(qa.float(), ka.float(), va.float(),
                                  ba.float(), rate, seed, **hk),
                out32[blk], rtol=0, atol=1e-6)
            torch.testing.assert_close(
                A.multi_head_attention(qa, ka, va, ba, dropout_rate=rate,
                                       deterministic=False, seed=seed,
                                       **hk), out[blk], rtol=0, atol=1e-12)
