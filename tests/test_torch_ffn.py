"""The port's fused FFN (plain version, K9 wrapper and its autograd
Function), the ``ffn_impl`` policy and a model with it on, against the JAX
package, on the CPU.

Inputs come from a seed through numpy. The JAX side runs ``ffn`` with
``impl="pallas"`` in interpret mode (``UNITER_PALLAS_INTERPRET=1``) and with
``impl="xla"``. On the CPU the K9 wrapper takes its plain version, so what
is held here is the arithmetic around the kernel. Tolerances: forward to
atol 1e-5, rtol 1e-4 (the Pallas kernel's polynomial erf is 1.5e-7 from
the true one, plus fp32 summation order, as tests/test_pallas_interpret.py
states); gradients to 1e-5 of each tensor's largest entry + 1e-6 (the same
two causes through the fp32 recompute). Rows stay powers of two, so
``pick_row_block`` takes one large block and the interpreter's grid is
short.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uniter_tpu_torch import config as pconfig
from uniter_tpu_torch.ops import ffn as pffn

jffn = importlib.import_module("uniter_tpu.ops.ffn")

torch.set_num_threads(2)

# (rows, D_in, D_mid, D_out)
SHAPES = [(32, 64, 128, 64), (16, 48, 192, 32), (64, 32, 64, 32)]


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    rows, d_in, d_mid, d_out = shape
    x = rng.randn(rows, d_in).astype(np.float32)
    w1 = (rng.randn(d_mid, d_in) * 0.2).astype(np.float32)  # torch [out, in]
    b1 = (rng.randn(d_mid) * 0.1).astype(np.float32)
    w2 = (rng.randn(d_out, d_mid) * 0.2).astype(np.float32)
    b2 = (rng.randn(d_out) * 0.1).astype(np.float32)
    g = rng.randn(rows, d_out).astype(np.float32)
    return x, w1, b1, w2, b2, g


def _jax_args(x, w1, b1, w2, b2):
    """JAX's layout: weights [in, out]."""
    return (jnp.asarray(x), jnp.asarray(w1.T), jnp.asarray(b1),
            jnp.asarray(w2.T), jnp.asarray(b2))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("UNITER_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax_pallas_and_xla(interpret, shape):
    x, w1, b1, w2, b2, _ = _inputs(shape)
    jargs = _jax_args(x, w1, b1, w2, b2)
    want_pallas = np.asarray(jffn.ffn(*jargs, impl="pallas"))
    want_xla = np.asarray(jffn.ffn(*jargs, impl="xla"))
    targs = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    before = pffn.ffn_fwd.launches
    for got in (pffn.ffn_plain(*targs), pffn.ffn_fwd(*targs),
                pffn.FfnFunction.apply(*targs),
                pffn.ffn(*targs, impl="cuda"), pffn.ffn(*targs, impl="xla")):
        assert got.shape == want_pallas.shape and got.dtype == torch.float32
        for want in (want_pallas, want_xla):
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       atol=1e-5, rtol=1e-4)
    assert pffn.ffn_fwd.launches == before  # a CPU tensor never launches


@pytest.mark.parametrize("shape", SHAPES)
def test_function_grads_match_jax_grad(interpret, shape):
    x, w1, b1, w2, b2, g = _inputs(shape, seed=1)

    def loss(*a):
        return jnp.sum(jffn.ffn(*a, impl="pallas") * jnp.asarray(g))

    want = [np.asarray(t) for t in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *_jax_args(x, w1, b1, w2, b2))]
    want[1], want[3] = want[1].T, want[3].T  # back to torch's layout
    targs = [torch.from_numpy(a).requires_grad_() for a in (x, w1, b1, w2, b2)]
    out = pffn.ffn(*targs, impl="cuda")
    out.backward(torch.from_numpy(g))
    for t, ref, name in zip(targs, want, ("dx", "dw1", "db1", "dw2", "db2")):
        assert t.grad.dtype == torch.float32
        np.testing.assert_allclose(
            t.grad.numpy(), ref, atol=1e-5 * np.abs(ref).max() + 1e-6,
            rtol=0, err_msg=name)


def test_function_gradcheck():
    """The explicit backward formula against numerical differences in
    float64 (the plain forward keeps float64)."""
    rng = np.random.RandomState(2)
    args = [torch.tensor(rng.randn(*s) * sc, dtype=torch.float64,
                         requires_grad=True)
            for s, sc in (((5, 8), 1.0), ((12, 8), 0.3), ((12,), 0.1),
                          ((6, 12), 0.3), ((6,), 0.1))]
    assert torch.autograd.gradcheck(pffn.FfnFunction.apply, args, eps=1e-6,
                                    atol=1e-5)


def test_bf16_rounds_the_intermediate_once(interpret):
    """bf16: x.W1 + b1 and the GELU in fp32, one rounding of h to bf16, the
    second product and b2 in fp32, one rounding of the result; biases stay
    fp32. Against the JAX Pallas kernel in interpret mode on the same bf16
    inputs: within one bf16 step (the erf polynomial can move a value of h
    across a rounding boundary). The unfused bf16 path rounds at other
    places and is further away from both."""
    x, w1, b1, w2, b2, _ = _inputs((32, 64, 128, 64), seed=3)
    xb, w1b, w2b = (torch.from_numpy(a).bfloat16() for a in (x, w1, w2))
    tb1, tb2 = torch.from_numpy(b1), torch.from_numpy(b2)
    got = pffn.ffn_plain(xb, w1b, tb1, w2b, tb2)
    assert got.dtype == torch.bfloat16
    pre = xb.double() @ w1b.double().t() + tb1.double()
    h = pffn._gelu(pre).float().bfloat16()
    want = (h.double() @ w2b.double().t() + tb2.double()).float().bfloat16()
    # the same value up to fp32 sums (one bf16 step at most)
    step = 2.0**-7 * want.float().abs() + 1e-6
    assert ((got.float() - want.float()).abs() <= step).all()
    jp = torch.tensor(np.asarray(jffn._ffn_pallas(
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(w1.T).astype(jnp.bfloat16), jnp.asarray(b1),
        jnp.asarray(w2.T).astype(jnp.bfloat16),
        jnp.asarray(b2)).astype(jnp.float32)))
    assert ((got.float() - jp).abs() <= 2.0**-7 * jp.abs() + 1e-6).all()
    unfused = pffn.ffn(xb, w1b, tb1, w2b, tb2, impl="xla")
    assert (unfused.float() - want.float()).abs().max() > \
        (got.float() - want.float()).abs().max()


def test_wrapper_checks_and_unknown_impl():
    x, w1, b1, w2, b2, _ = _inputs((8, 32, 64, 32))
    t = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    with pytest.raises(ValueError, match=r"w2 must be \(32, 64\)"):
        pffn.ffn_fwd(t[0], t[1], t[2], t[3][:, :16], t[4])
    with pytest.raises(ValueError, match="non-empty"):
        pffn.ffn_fwd(t[0][:0], *t[1:])
    with pytest.raises(ValueError, match="unknown ffn impl"):
        pffn.ffn(*t, impl="pallas")
    # [..., D] inputs keep their leading axes
    x3 = torch.from_numpy(x).reshape(2, 4, 32)
    assert pffn.ffn(x3, *t[1:], impl="cuda").shape == (2, 4, 32)


@pytest.mark.parametrize("shape,dtype", [
    ((33, 64, 144, 48), torch.float32), ((33, 64, 144, 48), torch.bfloat16),
    ((130, 96, 400, 80), torch.bfloat16),
    ((128, 768, 3072, 768), torch.float32)])
def test_tiled_twin_matches_plain_and_jax_pallas(interpret, shape, dtype):
    """``_ffn_tiled_torch``, K9's order of operations (64- or 32-row tiles,
    h in chunks, 64-product partials over D_in added in order, D_out in
    quarters taking the chunk's h units in turn), against ``ffn_plain`` and
    the JAX Pallas kernel in interpret mode, at small widths (a ragged row
    count, D_in, D_mid and D_out not multiples of 64, a partial last chunk)
    and at uniter-base's (768 -> 3072 -> 768). fp32: within 1e-5 of max(1,
    max|ref|) of ``ffn_plain`` (another fp32 summation order: the card's
    tolerance) and atol 1e-5, rtol 1e-4 of Pallas (its polynomial erf, as
    above). bf16: within two bf16 steps of |ref| + 1e-3 of both (the card's
    tolerance: another fp32 order can re-round a value of h)."""
    x, w1, b1, w2, b2, _ = _inputs(shape, seed=4)
    w1, w2 = w1 * 0.1, w2 * 0.1  # uniter-base's scale at D_in 768
    t = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    t[0], t[1], t[3] = (a.to(dtype) for a in (t[0], t[1], t[3]))
    got = pffn._ffn_tiled_torch(*t)
    assert got.dtype == dtype and got.shape == (shape[0], shape[3])
    want = pffn.ffn_plain(*t).float()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = torch.tensor(np.asarray(jffn._ffn_pallas(
        jnp.asarray(x).astype(jdt), jnp.asarray(w1.T).astype(jdt),
        jnp.asarray(b1), jnp.asarray(w2.T).astype(jdt),
        jnp.asarray(b2)).astype(jnp.float32)))
    diff = (got.float() - want).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-5 * max(1.0, want.abs().max().item())
        np.testing.assert_allclose(got.numpy(), jp.numpy(), atol=1e-5,
                                   rtol=1e-4)
    else:
        for ref in (want, jp):
            bound = 2.0**-6 * ref.abs() + 1e-3
            assert ((got.float() - ref).abs() - bound).max().item() <= 0


def _launch_args(d_in=64, d_mid=128, d_out=64, dtype=torch.bfloat16):
    x, w1, b1, w2, b2, _ = _inputs((8, d_in, d_mid, d_out))
    t = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    return [t[0].to(dtype), t[1].to(dtype), t[2], t[3].to(dtype), t[4]]


def _misaligned(t):
    """``t``'s values in a view 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)[2:2 + t.numel()]
    return flat.view(t.shape).copy_(t)


def test_one_look_check_sends_every_bad_input_to_the_full_checks():
    """``_fits`` (the launch path's one look at each tensor) takes the
    inputs a launch takes as they are, at D_out up to 1024; every input it
    refuses is either refused by the full checks (``_check_shapes``,
    ``_check_card``: the errors a card input raised before) or fixed by a
    copy (a tensor off a 16-byte boundary, a bias not in float32)."""
    good = _launch_args()
    assert pffn._fits(*good)
    pffn._check_card(*good)
    for d_out, ok in ((1024, True), (1040, False)):
        args = _launch_args(d_out=d_out)
        assert pffn._fits(*args) is ok
        if ok:
            pffn._check_card(*args)
        else:
            with pytest.raises(ValueError, match="<= 1024"):
                pffn._check_card(*args)
    x, w1, b1, w2, b2 = good
    raising = {
        "float16": ((x.half(), w1.half(), b1, w2.half(), b2), TypeError),
        "weights' dtype": ((x, w1.float(), b1, w2, b2), TypeError),
        "D_in 2048": (_launch_args(d_in=2048), ValueError),
        "D_in 24": (_launch_args(d_in=24), ValueError),
        "D_mid 136": (_launch_args(d_mid=136), ValueError),
        "strided x": ((x.t().contiguous().t(), w1, b1, w2, b2), ValueError),
        "strided b1": ((x, w1, torch.stack([b1, b1], 1)[:, 0], w2, b2),
                       ValueError),
        "w2 shape": ((x, w1, b1, w2[:, :64], b2), ValueError),
        "b2 shape": ((x, w1, b1, w2, b2[:32]), ValueError),
        "3-d x": ((x[None], w1, b1, w2, b2), ValueError),
        "no rows": ((x[:0], w1, b1, w2, b2), ValueError),
        "two devices": ((x, w1.to("meta"), b1, w2, b2), ValueError)}
    for name, (args, err) in raising.items():
        assert not pffn._fits(*args), name
        with pytest.raises(err):
            pffn._check_shapes(*args)
            pffn._check_card(*args)
    # the short path also asks for a card: any other device goes to the
    # full checks, which take the CPU and refuse the rest
    meta = [a.to("meta") for a in good]
    assert not meta[0].is_cuda
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        pffn.ffn_fwd(*meta)
    fixed = {"misaligned x": (_misaligned(x), w1, b1, w2, b2),
             "misaligned w2": (x, w1, b1, _misaligned(w2), b2),
             "bf16 b1": (x, w1, b1.bfloat16(), w2, b2)}
    for name, args in fixed.items():
        assert not pffn._fits(*args), name
        pffn._check_shapes(*args)
        pffn._check_card(*args)
    # a CPU input never takes the launch path: the plain version answers
    before = pffn.ffn_fwd.launches
    assert torch.equal(pffn.ffn_fwd(*good), pffn.ffn_plain(*good))
    assert pffn.ffn_fwd.launches == before


@pytest.mark.parametrize("given,device,want", [
    ("xla", "cpu", "xla"), ("pallas", "cpu", "xla"), ("cuda", "cpu", "xla"),
    ("xla", "cuda", "xla"), ("pallas", "cuda", "cuda"),
    ("cuda", "cuda:0", "cuda")])
def test_resolve_ffn_impl(given, device, want):
    cfg = pconfig.tiny_config(ffn_impl=given)
    for training in (False, True):
        got = pconfig.resolve_kernel_policies(cfg, device, training=training)
        assert got.ffn_impl == want
    with pytest.raises(ValueError, match="ffn_impl"):
        pconfig.resolve_kernel_policies(
            pconfig.tiny_config(ffn_impl="auto"), device)


# ---------------------------------------------------------- the model

IMG_DIM = 32


def _batch(n=4, t=8, r=6, seed=0):
    rng = np.random.RandomState(seed)
    attn = np.ones((n, t + r), np.int32)
    attn[0, t - 3:t] = 0
    attn[1, t + r - 2:] = 0
    return dict(
        input_ids=rng.randint(1, 500, (n, t)).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (n, 1)),
        img_feat=rng.randn(n, r, IMG_DIM).astype(np.float32),
        img_pos_feat=rng.rand(n, r, 7).astype(np.float32),
        attn_mask=attn)


def test_unresolved_model_with_ffn_on_matches_jax(interpret):
    """A 2-layer retrieval model built unresolved with the FFN kernel on
    (JAX ``ffn_impl="pallas"`` in interpret mode; the port ``"cuda"`` on
    CPU tensors, where the wrapper runs ``ffn_plain``): scores to 1e-5,
    the rank loss's gradients to 1e-5 of each tensor's largest entry; the
    port's model with the FFN off gives the same numbers to 1e-5."""
    from uniter_tpu.config import tiny_config as jax_tiny
    from uniter_tpu.models.itm import UniterForImageTextRetrieval as JItm
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
    from uniter_tpu_torch.models.itm import UniterForImageTextRetrieval

    nodrop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JItm(jax_tiny(ffn_impl="pallas", **nodrop), img_dim=IMG_DIM)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jb,
                         False)["params"]
    rng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)).astype(
            np.float32), jax.tree.map(np.asarray, dict(params)))
    want = np.asarray(jmodel.apply({"params": params}, jb, False))
    want_grads = state_dict_from_jax_params(jax.grad(
        lambda p: jnp.mean(jmodel.apply({"params": p}, jb, True,
                                        sample_size=2)))(
        jax.tree.map(jnp.asarray, params)))
    sd = {k: torch.tensor(v) for k, v in
          state_dict_from_jax_params(params).items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    outs = {}
    for impl in ("cuda", "xla"):
        model = UniterForImageTextRetrieval(
            pconfig.tiny_config(ffn_impl=impl, **nodrop), img_dim=IMG_DIM)
        model.load_state_dict(sd, strict=True)
        assert all(layer.fused_ffn == (impl == "cuda")
                   for layer in model.uniter.encoder.layer)
        outs[impl] = model(tb, False).detach().numpy()
        model(tb, True, sample_size=2).mean().backward()
        for k, p in model.named_parameters():
            if k not in want_grads:
                continue
            ref = np.asarray(want_grads[k])
            got = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
            np.testing.assert_allclose(got, ref,
                                       atol=1e-5 * np.abs(ref).max() + 1e-6,
                                       rtol=0, err_msg=f"{impl} {k}")
    np.testing.assert_allclose(outs["cuda"], want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(outs["xla"], outs["cuda"], atol=1e-5, rtol=0)
