"""The port's optimal-transport ops against the JAX package, on the CPU.

Inputs come from a seed through numpy and go to both frameworks in fp32.
The JAX side runs its ``lax.scan`` reference (``impl="xla"``) and its Pallas
kernel in interpret mode (``impl="pallas"`` under
``UNITER_PALLAS_INTERPRET=1``); the port runs ``ipot``, the plain version
that is K7's oracle, directly and through ``ipot_cuda`` (which takes it for
a CPU tensor).

Tolerances: the plan T to atol 1e-5 and the distance to rtol 1e-4 / atol
1e-5, the bound ``tests/test_ot_parity.py`` holds the JAX scan to: fp32
rounding of other summation orders carried through 50 dependent steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uniter_tpu.ops import ot as jot
from uniter_tpu_torch.ops import ot as pot

torch.set_num_threads(2)

B, M, N, D = 3, 7, 5, 16


def _inputs(b=B, m=M, n=N, d=D, seed=0, all_pad_row=None):
    """Embeddings and ragged padding: every example has valid tokens and
    regions unless ``all_pad_row`` names one that is all padding (a
    batch-padding row of ``ItmDataset.collate``)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, m, d).astype(np.float32)
    y = rng.randn(b, n, d).astype(np.float32)
    x_len = rng.randint(2, m + 1, b)
    y_len = rng.randint(2, n + 1, b)
    x_len[0], y_len[0] = m, n
    if all_pad_row is not None:
        x_len[all_pad_row] = y_len[all_pad_row] = 0
    x_pad = np.arange(m)[None, :] >= x_len[:, None]
    y_pad = np.arange(n)[None, :] >= y_len[:, None]
    return x, y, x_pad, y_pad


def _plan_args(x, y, x_pad, y_pad, lib):
    """(C, x_len, x_pad, y_len, y_pad, joint_pad) for ``ipot`` in either
    framework, as ``optimal_transport_dist`` prepares them."""
    if lib is jot:
        xa, ya, xp, yp = map(jnp.asarray, (x, y, x_pad, y_pad))
        cost = lib.cost_matrix_cosine(xa, ya)
        joint = xp[:, :, None] | yp[:, None, :]
        cost = jnp.where(joint, 0.0, cost)
        return (cost, jnp.sum(~xp, 1).astype(jnp.float32), xp,
                jnp.sum(~yp, 1).astype(jnp.float32), yp, joint)
    xa, ya, xp, yp = map(torch.from_numpy, (x, y, x_pad, y_pad))
    cost = lib.cost_matrix_cosine(xa, ya)
    joint = xp[:, :, None] | yp[:, None, :]
    cost = cost.masked_fill(joint, 0.0)
    return (cost, (~xp).sum(1).float(), xp, (~yp).sum(1).float(), yp, joint)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("UNITER_PALLAS_INTERPRET", "1")


def test_cost_matrix_cosine_matches_jax():
    x, y, _, _ = _inputs()
    x[1, 2] = 0.0  # a zero vector: the norm clamps at eps
    want = np.asarray(jot.cost_matrix_cosine(jnp.asarray(x), jnp.asarray(y)))
    got = pot.cost_matrix_cosine(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (B, M, N)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("jax_fn", ["ipot", "ipot_pallas"])
def test_ipot_matches_jax(interpret, jax_fn, k):
    """T against the JAX scan and the Pallas kernel (interpret), k = 1 and
    the inner loop k = 2; exactly zero where the plan is masked."""
    ins = _inputs(seed=1)
    want = np.asarray(getattr(jot, jax_fn)(*_plan_args(*ins, jot), 0.5, 50,
                                           k))
    args = _plan_args(*ins, pot)
    for fn in (pot.ipot, pot.ipot_cuda):
        got = fn(*args, 0.5, 50, k)
        assert got.shape == (B, N, M) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        assert (got[args[5].transpose(1, 2)] == 0).all()
    assert pot.ipot_cuda.launches == 0  # a CPU tensor never launches


def test_ipot_all_padding_example_is_zero_and_finite(interpret):
    ins = _inputs(b=4, seed=2, all_pad_row=2)
    args = _plan_args(*ins, pot)
    got = pot.ipot(*args, 0.5, 50, 1)
    assert torch.isfinite(got).all()
    assert (got[2] == 0).all()
    want = np.asarray(jot.ipot_pallas(*_plan_args(*ins, jot), 0.5, 50, 1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("k", [1, 2])
def test_optimal_transport_dist_matches_jax(interpret, jimpl, k):
    x, y, x_pad, y_pad = _inputs(b=4, seed=3, all_pad_row=3)
    want = np.asarray(jot.optimal_transport_dist(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(x_pad),
        jnp.asarray(y_pad), k=k, impl=jimpl))
    for impl in ("xla", "cuda"):
        got = pot.optimal_transport_dist(
            torch.from_numpy(x), torch.from_numpy(y),
            torch.from_numpy(x_pad), torch.from_numpy(y_pad), k=k, impl=impl)
        assert got.shape == (4,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert got[3] == 0 and np.isfinite(got.numpy()).all()


def test_distance_gradients_match_jax():
    """d sum(dist) / d txt_emb and d img_emb against ``jax.grad``: the plan
    is a constant, gradients flow through the cosine cost alone."""
    x, y, x_pad, y_pad = _inputs(seed=4)

    def total(xa, ya):
        return jnp.sum(jot.optimal_transport_dist(
            xa, ya, jnp.asarray(x_pad), jnp.asarray(y_pad), impl="xla"))

    want_x, want_y = jax.grad(total, argnums=(0, 1))(jnp.asarray(x),
                                                     jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    pot.optimal_transport_dist(xt, yt, torch.from_numpy(x_pad),
                               torch.from_numpy(y_pad)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(want_y),
                               atol=1e-5, rtol=0)


def test_plan_carries_no_gradient():
    x, y, x_pad, y_pad = _inputs(seed=5)
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    xp, yp = torch.from_numpy(x_pad), torch.from_numpy(y_pad)
    seen = []
    real = pot.ipot

    def spy(cost, *a):
        assert not cost.requires_grad and not torch.is_grad_enabled()
        seen.append(real(cost, *a))
        return seen[-1]

    pot.ipot = spy
    try:
        dist = pot.optimal_transport_dist(xt, yt, xp, yp)
    finally:
        pot.ipot = real
    assert len(seen) == 1 and not seen[0].requires_grad
    assert dist.requires_grad


def test_ipot_form_and_argument_checks():
    """The kernel's three forms by plan size (232,448 bytes of shared
    memory), and what the wrapper refuses."""
    assert pot.ipot_form(64, 160) == 0  # the pretrain-mix bucket
    assert pot.ipot_form(100, 64) == 0
    assert pot.ipot_form(100, 512) == 1  # T in device memory
    assert pot.ipot_form(200, 512) == 2  # A too
    with pytest.raises(ValueError, match=r"\[40000, 40000\]"):
        pot.ipot_form(40000, 40000)
    args = list(_plan_args(*_inputs(), pot))
    with pytest.raises(ValueError, match="k >= 1"):
        pot.ipot_cuda(*args, 0.5, 50, 0)
    bad = list(args)
    bad[2] = bad[2].float()
    with pytest.raises(TypeError, match="x_pad must be bool"):
        pot.ipot_cuda(*bad, 0.5, 50, 1)
    bad = list(args)
    bad[5] = bad[5][:, :, :-1]
    with pytest.raises(ValueError, match="joint_pad"):
        pot.ipot_cuda(*bad, 0.5, 50, 1)
    with pytest.raises(ValueError, match="unknown ot impl"):
        pot.optimal_transport_dist(
            torch.zeros(1, 2, 4), torch.zeros(1, 2, 4),
            torch.zeros(1, 2, dtype=torch.bool),
            torch.zeros(1, 2, dtype=torch.bool), impl="auto")


@pytest.mark.parametrize("n,m,form", [
    (1, 1, 0), (128, 160, 0), (129, 160, 1), (128, 161, 1), (16, 545, 1),
    (100, 512, 1), (100, 544, 1), (100, 545, 2), (200, 512, 2),
    (1000, 4000, 2)])
def test_ipot_form_limits(n, m, form):
    """The register form holds N <= 128, M <= 160; form 1 A in shared memory
    (N rows of M rounded up to 32, and the 2 (N + M) vectors, within
    232,448 bytes); form 2 the vectors alone."""
    assert pot.ipot_form(n, m) == form
    pm = -(-m // 32) * 32
    smem = 4 * (n * pm + 2 * (n + m))
    assert (form == 0) == (n <= 128 and m <= 160)
    if form == 1:
        assert smem <= 232448
    if form == 2:
        assert smem > 232448 >= 4 * 2 * (n + m)


def _refused(case):
    """``ipot_cuda``'s arguments broken one way (``case``), and the error
    that must come of them."""
    args = list(_plan_args(*_inputs(), pot)) + [0.5, 50, 1]
    if case == "C not 3-D":
        args[0] = args[0][0]
        return args, ValueError, r"C must be \[B, M, N\]"
    if case == "lengths shape":
        args[1] = args[1][:-1]
        return args, ValueError, "x_len must be"
    if case == "joint_pad shape":
        args[5] = args[5][:, :, :-1]
        return args, ValueError, "joint_pad must be"
    if case == "pad dtype":
        args[4] = args[4].to(torch.uint8)
        return args, TypeError, "y_pad must be bool"
    if case == "C dtype":
        args[0] = args[0].to(torch.int32)
        return args, TypeError, "C must be floating point"
    if case == "mixed devices":
        args[3] = args[3].to("meta")
        return args, ValueError, "y_len must be"
    if case == "device":
        args[:6] = [a.to("meta") for a in args[:6]]
        return args, ValueError, "runs on cuda or cpu, not meta"
    if case == "k < 1":
        args[8] = 0
        return args, ValueError, "k >= 1"
    args[7] = -1
    return args, ValueError, "iteration >= 0"


@pytest.mark.parametrize("case", [
    "C not 3-D", "lengths shape", "joint_pad shape", "pad dtype", "C dtype",
    "mixed devices", "device", "k < 1", "iteration < 0"])
def test_ipot_cuda_refuses_before_any_work(monkeypatch, case):
    """Each refusal raises before the plan is computed: the plain loop that
    a CPU input takes is never entered."""
    args, err, match = _refused(case)

    def no_work(*a):
        raise AssertionError("ipot_cuda computed a plan before refusing")

    monkeypatch.setattr(pot, "ipot", no_work)
    with pytest.raises(err, match=match):
        pot.ipot_cuda(*args)


@pytest.mark.parametrize("k", [1, 2])
def test_ipot_takes_joint_padding_as_given_like_jax(interpret, k):
    """A joint padding wider than the outer OR of the pads (the kernel
    reads it as given, not rebuilt from the pads): ``ipot`` and
    ``ipot_cuda`` against JAX ``ipot`` and ``ipot_pallas`` in interpret
    mode, exactly zero where it is masked."""
    ins = _inputs(b=4, seed=6, all_pad_row=2)
    jargs = list(_plan_args(*ins, jot))
    args = list(_plan_args(*ins, pot))
    extra = np.random.RandomState(7).rand(4, M, N) < 0.3
    extra[:, 0, :] = extra[:, :, 0] = False  # no valid row or column empty
    jargs[5] = jargs[5] | jnp.asarray(extra)
    args[5] = args[5] | torch.from_numpy(extra)
    for jax_fn in (jot.ipot, jot.ipot_pallas):
        want = np.asarray(jax_fn(*jargs, 0.5, 50, k))
        for fn in (pot.ipot, pot.ipot_cuda):
            got = fn(*args, 0.5, 50, k)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
            assert (got[args[5].transpose(1, 2)] == 0).all()


@pytest.mark.parametrize("case", ["bf16", "strided", "int lengths",
                                  "zero lengths"])
def test_ipot_cuda_on_the_cpu_fixes_what_the_card_fixes(case):
    """What the card's wrapper casts or copies gives, on the CPU, the plan
    of the fp32 contiguous inputs it becomes: a bf16 cost, a transposed
    view, integer lengths. Lengths of 0 where one side of an example is all
    padding and the other is not (the clamp lifts them to 1; the plan is
    masked everywhere there): zero, as JAX ``ipot`` gives."""
    x, y, x_pad, y_pad = _inputs(b=4, seed=8)
    if case == "zero lengths":
        x_pad[0] = True
        y_pad[2] = True
    args = list(_plan_args(x, y, x_pad, y_pad, pot))
    same = list(args)
    if case == "bf16":
        args[0] = args[0].bfloat16()
        same[0] = args[0].float()
    elif case == "strided":
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
        assert not args[0].is_contiguous()
    elif case == "int lengths":
        args[1], args[3] = args[1].long(), args[3].int()
    else:
        assert args[1][0] == 0 and args[3][2] == 0
        want = np.asarray(jot.ipot(*_plan_args(x, y, x_pad, y_pad, jot),
                                   0.5, 50, 1))
        got = pot.ipot_cuda(*args, 0.5, 50, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        assert (got[0] == 0).all() and (got[2] == 0).all()
    assert torch.equal(pot.ipot_cuda(*args, 0.5, 50, 1),
                       pot.ipot(*same, 0.5, 50, 1))


def test_one_look_check_sends_every_other_input_to_the_full_checks():
    """``_fits`` takes exactly what a launch takes as it is (fp32
    contiguous C and lengths, contiguous bool pads, k >= 1); every input it
    refuses either raises in ``_check`` or becomes, through
    ``_card_inputs``, one that it takes."""
    base = list(_plan_args(*_inputs(), pot)) + [50, 1]
    assert pot._fits(*base)
    variants = {
        "bf16 C": (0, base[0].bfloat16()),
        "strided C": (0, base[0].transpose(1, 2).contiguous()
                      .transpose(1, 2)),
        "int lengths": (1, base[1].long()),
        "strided lengths": (3, torch.stack([base[3], base[3]], 1)[:, 0]),
        "strided pad": (2, torch.stack([base[2], base[2]], 2)[:, :, 0]),
        "float pad": (4, base[4].float()),
        "short joint_pad": (5, base[5][:, :, :-1]),
        "int C": (0, base[0].int()),
        "k 0": (7, 0),
        "iteration -1": (6, -1),
    }
    for name, (i, value) in variants.items():
        args = list(base)
        args[i] = value
        assert not pot._fits(*args), name
        try:
            pot._check(*args)
        except (TypeError, ValueError):
            continue
        fixed = pot._card_inputs(*args[:6])
        assert pot._fits(*fixed, *args[6:]), name
        assert all(a.is_contiguous() for a in fixed), name
