"""The port's fused dropout + residual + LayerNorm tails (K3-K6) against the
JAX package, on the CPU.

* The plain forwards ``_drop_res_ln_torch`` and ``_ln_drop_torch`` at rate 0
  in fp32 equal JAX ``drop_res_ln``/``ln_drop`` with ``impl="pallas"``
  (interpret mode, as tests/test_pallas_interpret.py runs them; rows not a
  multiple of 8 take the JAX package's own fallback) and ``impl="xla"``, to
  1e-5 (fp32 rounding of another summation order over H).
* The explicit backward formulas equal ``jax.grad`` of the XLA path at rate
  0: dx/dres to 1e-5, dw/db (sums over rows) to 1e-5 of their largest
  entry.
* At rate 0.1 and 0.5: the formulas equal float64 autograd through the
  plain composition on the same Philox mask (1e-10); the zeros of the
  dropped tensors sit exactly where ``keep_mask(seed, 0, shape)`` says;
  ``gradcheck`` passes through ``DropResLNFunction``/``LNDropFunction`` in
  float64.
* The wrappers refuse what the kernels do not take.
* ``_sum_partials_torch``, the backward kernels' fixed-order sum of their
  per-block dw/db partials in torch, is within 1e-4 of the float64 sum and
  takes the kernel's order, one fp32 addition at a time.
* A tiny VQA model trained 3 steps at dropout 0.1 with ``block_fusion``
  forced to "cuda" (the Functions, with their plain bodies on the CPU)
  matches "none" (the trunk's plain composition) to fp32 rounding: the two
  paths draw the same seeds in the same order, so the same masks.
* The inference route (``ops.fused_block.inference_tail``), with
  ``_launchable`` and the forward launch stood in for (the kernels run
  only on the card): a forward that records no gradient and draws no mask
  calls K3 at every residual tail (the retrieval scorer's
  ``BertLayerCLS`` too) and K5 at every embedding tail, at rate 0 with
  the tail's own weight, bias and eps, and scores as the plain path does; a recorded gradient, a live mask or a tensor
  ``_launchable`` refuses keeps the plain path; the counters ``tail.fused``
  and ``tail.plain`` add one a tail inside a trace session and nothing
  outside one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uniter_tpu_torch import config as pconfig
from uniter_tpu_torch.ops import fused_block as fb
from uniter_tpu_torch.ops.dropout import keep_mask

torch.set_num_threads(2)

SHAPES = [(32, 24), (2, 13, 64), (4, 9, 768)]


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    h = shape[-1]
    return dict(x=rng.randn(*shape).astype(np.float32),
                res=rng.randn(*shape).astype(np.float32),
                g=rng.randn(*shape).astype(np.float32),
                w=(1.0 + 0.1 * rng.randn(h)).astype(np.float32),
                b=(0.1 * rng.randn(h)).astype(np.float32))


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(a, dtype=dtype, requires_grad=grad)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("UNITER_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tail", ["drop_res_ln", "ln_drop"])
def test_plain_forward_matches_jax(pallas_interpret, tail, shape, impl):
    from uniter_tpu.ops import fused_block as jfb

    d = _inputs(shape)
    if tail == "drop_res_ln":
        want = jfb.drop_res_ln(jnp.asarray(d["x"]), jnp.asarray(d["res"]),
                               jnp.asarray(d["w"]), jnp.asarray(d["b"]),
                               impl=impl)
        got = fb._drop_res_ln_torch(_t(d["x"]), _t(d["res"]), _t(d["w"]),
                                    _t(d["b"]))
    else:
        want = jfb.ln_drop(jnp.asarray(d["x"]), jnp.asarray(d["w"]),
                           jnp.asarray(d["b"]), impl=impl)
        got = fb._ln_drop_torch(_t(d["x"]), _t(d["w"]), _t(d["b"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("shape", [(32, 24), (4, 9, 768)])
@pytest.mark.parametrize("tail", ["drop_res_ln", "ln_drop"])
def test_backward_formula_matches_jax_grad(tail, shape):
    from uniter_tpu.ops import fused_block as jfb

    d = _inputs(shape, seed=1)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    if tail == "drop_res_ln":
        _, vjp = jax.vjp(lambda x, r, w, b: jfb.drop_res_ln(x, r, w, b,
                                                            impl="xla"),
                         j["x"], j["res"], j["w"], j["b"])
        want = vjp(j["g"])  # dx, dres, dw, db
        got = fb._drop_res_ln_bwd_torch(_t(d["x"]), _t(d["res"]), _t(d["w"]),
                                        _t(d["g"]))
    else:
        _, vjp = jax.vjp(lambda x, w, b: jfb.ln_drop(x, w, b, impl="xla"),
                         j["x"], j["w"], j["b"])
        want = vjp(j["g"])  # dx, dw, db
        got = fb._ln_drop_bwd_torch(_t(d["x"]), _t(d["w"]), _t(d["g"]))
    assert len(got) == len(want)
    for gt, wt in zip(got, want):
        wt = np.asarray(wt)
        scale = 1.0 if wt.ndim > 1 else max(1.0, np.abs(wt).max())
        np.testing.assert_allclose(gt.numpy(), wt, atol=1e-5 * scale, rtol=0)


def _composition(tail, x, res, w, b, keep, rate):
    """The plain composition, in x's dtype (float64 here): dropout by the
    given mask, LayerNorm with biased variance and eps 1e-12."""
    def ln(t):
        mean = t.mean(-1, keepdim=True)
        var = (t - mean).square().mean(-1, keepdim=True)
        return (t - mean) / torch.sqrt(var + 1e-12) * w + b

    def drop(t):
        return torch.where(keep, t / (1.0 - rate), torch.zeros((),
                                                                dtype=t.dtype))

    return ln(drop(x) + res) if tail == "drop_res_ln" else drop(ln(x))


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("tail", ["drop_res_ln", "ln_drop"])
def test_dropout_backward_equals_autograd_on_the_same_mask(tail, rate):
    d = _inputs((3, 7, 64), seed=2)
    x, res, w, b = (_t(d[k], torch.float64, grad=True)
                    for k in ("x", "res", "w", "b"))
    g = _t(d["g"], torch.float64)
    seed = 1234
    keep = keep_mask(seed, 0, x.shape, rate)
    assert 0 < keep.sum() < keep.numel()
    y = _composition(tail, x, res, w, b, keep, rate)
    y.backward(g)
    grads = [None if t.grad is None else t.grad.numpy()
             for t in (x, res, w, b)]  # ln_drop reads no res
    x, res, w, b = (t.detach() for t in (x, res, w, b))
    if tail == "drop_res_ln":
        fwd = fb._drop_res_ln_torch(x, res, w, b, rate, seed)
        dx, dres, dw, db = fb._drop_res_ln_bwd_torch(x, res, w, g, rate, seed)
        np.testing.assert_allclose(dres.numpy(), grads[1], atol=1e-10)
        # dx is zero exactly where the mask drops x
        assert torch.equal(dx == 0, ~keep)
    else:
        fwd = fb._ln_drop_torch(x, w, b, rate, seed)
        dx, dw, db = fb._ln_drop_bwd_torch(x, w, g, rate, seed)
        # the output is zero exactly where the mask drops it
        assert torch.equal(fwd == 0, ~keep)
    np.testing.assert_allclose(fwd.detach().numpy(), y.detach().numpy(),
                               atol=1e-10)
    for got, want in zip((dx, dw, db), (grads[0], grads[2], grads[3])):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-10)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_functions_gradcheck_float64(rate):
    rng = np.random.RandomState(3)
    x, res = (torch.tensor(rng.randn(2, 5, 8), dtype=torch.float64,
                           requires_grad=True) for _ in range(2))
    w = torch.tensor(1.0 + 0.1 * rng.randn(8), dtype=torch.float64,
                     requires_grad=True)
    b = torch.tensor(0.1 * rng.randn(8), dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, r, w, b: fb.DropResLNFunction.apply(x, r, w, b, rate, 7,
                                                      1e-12),
        (x, res, w, b), eps=1e-6, atol=1e-6)
    assert torch.autograd.gradcheck(
        lambda x, w, b: fb.LNDropFunction.apply(x, w, b, rate, 7, 1e-12),
        (x, w, b), eps=1e-6, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    d = _inputs((4, 8))
    x, res, w, b = (_t(d[k]) for k in ("x", "res", "w", "b"))
    with pytest.raises(TypeError):
        fb.drop_res_ln_fwd(x, res.bfloat16(), w, b)
    with pytest.raises(TypeError):
        fb.ln_drop_fwd(x, w.bfloat16(), b)
    with pytest.raises(ValueError):
        fb.drop_res_ln_fwd(x, res[:2], w, b)
    with pytest.raises(ValueError):
        fb.ln_drop_fwd(x, w[:4], b)
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError):
            fb.ln_drop_fwd(x, w, b, rate, 3)
    with pytest.raises(ValueError):
        fb.drop_res_ln_bwd(x, res, w, x, 0.1, -1)
    with pytest.raises(ValueError):
        fb.ln_drop_fwd(x[:0], w, b)
    with pytest.raises(ValueError):
        fb.drop_res_ln(x, res, w, b, impl="pallas")
    with pytest.raises(TypeError):  # float16 activations
        fb.ln_drop_fwd(x.half(), w, b)
    with pytest.raises(TypeError):  # float64 activations, float32 weights
        fb.ln_drop_bwd(x.double(), w, x.double())
    with pytest.raises(ValueError):  # a scalar
        fb.ln_drop_fwd(x[0, 0], w, b)
    with pytest.raises(ValueError):  # two devices
        fb.ln_drop_fwd(x, w.to("meta"), b)
    with pytest.raises(ValueError):  # neither cuda nor cpu
        fb.drop_res_ln_bwd(*(t.to("meta") for t in (x, res, w, x)))
    for t in (x, x.to("meta")):  # only a CUDA tensor takes the short check
        assert not fb._launchable((t, t), (w.to(t.device),), 0.0, 0)
    # a CPU tensor takes the plain version and launches nothing
    before = fb.drop_res_ln_fwd.launches
    y = fb.drop_res_ln_fwd(x, res, w, b, 0.1, 3)
    assert fb.drop_res_ln_fwd.launches == before
    assert torch.equal(y, fb._drop_res_ln_torch(x, res, w, b, 0.1, 3))


@pytest.mark.parametrize("n,h", [(1, 24), (7, 24), (16, 772), (132, 768),
                                 (264, 768), (1056, 64)])
def test_sum_partials_torch_matches_float64(n, h):
    """The fixed-order fp32 sum of the backward kernels' per-block dw/db
    partials against the float64 sum, within chip_smoke.py's TAIL_DWDB_REL
    (1e-4 of the largest entry)."""
    rng = np.random.RandomState(n + h)
    part = rng.randn(2, n, h).astype(np.float32) * rng.uniform(
        0.1, 10.0, (2, n, 1)).astype(np.float32)
    got = fb._sum_partials_torch(torch.from_numpy(part))
    want = part.astype(np.float64).sum(1)
    assert got.dtype == torch.float32 and got.shape == (2, h)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_sum_partials_torch_takes_the_kernel_order():
    """``_sum_partials_torch`` equals, bit for bit, the order written out
    one fp32 addition at a time: slice j of SUM_SLICES adds blocks j, j +
    SUM_SLICES, ... from 0, then the slices pairwise, (0+1), (2+3), ...,
    down to one (``csrc/fused_tail.cu`` ``sum_partials``). Values of mixed
    magnitude make another order show."""
    rng = np.random.RandomState(11)
    n, h, k = 37, 5, fb.SUM_SLICES
    part = (rng.randn(2, n, h) * 10.0 ** rng.randint(-4, 5, (2, n, h))
            ).astype(np.float32)
    want = np.empty((2, h), np.float32)
    for q in range(2):
        for c in range(h):
            s = [np.float32(0.0)] * k
            for blk in range(n):
                s[blk % k] = np.float32(s[blk % k] + part[q, blk, c])
            while len(s) > 1:
                s = [np.float32(s[2 * j] + s[2 * j + 1])
                     for j in range(len(s) // 2)]
            want[q, c] = s[0]
    got = fb._sum_partials_torch(torch.from_numpy(part)).numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(got, part.sum(1, dtype=np.float32))


def test_bf16_activations_take_fp32_arithmetic():
    """bf16 x/res: the result is the fp32 formula on the bf16 inputs,
    rounded once to bf16; dw/db stay fp32."""
    d = _inputs((6, 32), seed=4)
    x, res, g = (_t(d[k]).bfloat16() for k in ("x", "res", "g"))
    w, b = _t(d["w"]), _t(d["b"])
    y = fb.drop_res_ln_fwd(x, res, w, b, 0.1, 5)
    ref = fb._drop_res_ln_torch(x.float(), res.float(), w, b, 0.1, 5)
    assert y.dtype == torch.bfloat16 and torch.equal(y, ref.bfloat16())
    dx, dres, dw, db = fb.drop_res_ln_bwd(x, res, w, g, 0.1, 5)
    assert dx.dtype == dres.dtype == torch.bfloat16
    assert dw.dtype == db.dtype == torch.float32


def test_fused_tails_train_as_the_plain_composition(monkeypatch):
    """3 steps of the tiny VQA model at dropout 0.1: block_fusion "cuda"
    (DropResLNFunction/LNDropFunction on the CPU) against "none". Same
    initial weights and generator seeds; losses to rtol 1e-5 and
    parameters to atol 1e-5 (fp32 rounding: x * (1/(1-rate)) against
    x / (1-rate), and the sums of the formula against autograd's)."""
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch.train_vqa import vqa_loss
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training import sched as psched
    from uniter_tpu_torch.training import step as pstep

    rng = np.random.RandomState(5)
    b, t, r = 4, 8, 6
    attn = np.ones((b, t + r), np.int32)
    attn[0, t - 2:t] = 0
    batch = {k: torch.from_numpy(v) for k, v in dict(
        input_ids=rng.randint(1, 500, (b, t)).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        img_feat=rng.randn(b, r, 32).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=attn,
        targets=(rng.rand(b, 11) < 0.2).astype(np.float32),
        ex_weight=np.ones(b, np.float32)).items()}

    def run(block_fusion):
        torch.manual_seed(0)
        model = UniterForVisualQuestionAnswering(
            pconfig.tiny_config(block_fusion=block_fusion), img_dim=32,
            num_answer=11)
        opt = popt.build_optimizer(model, psched.get_lr_schedule(1e-3, 1, 3),
                                   fused=True)
        state = pstep.TrainState(step=0, model=model, opt=opt)
        step = pstep.make_train_step(
            lambda m, bt, g: (vqa_loss(m, bt, g, 11), {}))
        losses = [float(step(state, batch, seed=11)[1]["loss"])
                  for _ in range(3)]
        return losses, dict(model.named_parameters())

    calls = {}
    for name in ("drop_res_ln_fwd", "ln_drop_fwd"):
        def counted(*a, _orig=getattr(fb, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a)

        monkeypatch.setattr(fb, name, counted)
    fused_losses, fused_params = run("cuda")
    # 2 layers x 2 sub-block tails, 2 embedding tails, per step
    assert calls == {"drop_res_ln_fwd": 12, "ln_drop_fwd": 6}
    plain_losses, plain_params = run("none")
    np.testing.assert_allclose(fused_losses, plain_losses, rtol=1e-5)
    assert len(set(plain_losses)) == 3
    for k, p in plain_params.items():
        np.testing.assert_allclose(fused_params[k].detach().numpy(),
                                   p.detach().numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)


def _scorer_inputs():
    """A tiny retrieval model's scorer (layer 0 through the trunk, layer 1
    as ``BertLayerCLS``) and a 3-pair batch: 2 embedding tails and 4
    residual tails a forward."""
    from uniter_tpu_torch.models.itm import UniterForImageTextRetrieval
    from uniter_tpu_torch.utils.itm_fast import _Scorer

    torch.manual_seed(0)
    model = UniterForImageTextRetrieval(pconfig.tiny_config(), img_dim=16)
    model.eval()
    scorer = _Scorer(model)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(1, 500, (3, 6)))
    feat = torch.from_numpy(rng.randn(3, 4, 16).astype(np.float32))
    pos = torch.from_numpy(rng.rand(3, 4, 7).astype(np.float32))
    mask = torch.ones(3, 10, dtype=torch.int32)
    mask[0, 4:6] = 0

    def score():
        emb = torch.cat([scorer.embed_txt(ids), scorer.embed_img(feat, pos)],
                        1)
        return scorer.score_rows(emb, mask)

    return scorer, score


def _tails(scorer):
    """The tails a scoring forward runs: the embeddings', layers 0..L-2's
    and ``BertLayerCLS``'s (not the trunk's last layer)."""
    from uniter_tpu_torch.models.encoder import _Tail

    u = scorer.uniter
    return [m for mod in (u.embeddings, u.img_embeddings,
                          *u.encoder.layer[:-1], scorer.cls_layer)
            for m in mod.modules() if isinstance(m, _Tail)]


def _stand_in(monkeypatch, launchable=True):
    """``_launchable`` answering ``launchable``, and the forward launch
    (``_tail_fwd``) recording its calls and computing the plain forwards."""
    calls = []
    monkeypatch.setattr(fb, "_launchable", lambda *a, **k: launchable)

    def launch(x, res, weight, bias, rate, seed, eps, row_base=0):
        name = "ln_drop_fwd" if res is None else "drop_res_ln_fwd"
        calls.append((name, weight, bias, rate, seed, eps))
        if res is None:
            return fb._ln_drop_torch(x, weight, bias, rate, seed, eps,
                                     row_base)
        return fb._drop_res_ln_torch(x, res, weight, bias, rate, seed, eps,
                                     row_base)

    monkeypatch.setattr(fb, "_tail_fwd", launch)
    return calls


def test_inference_tails_launch_the_fused_kernels_at_rate_0(monkeypatch):
    """Under ``inference_mode`` every tail calls its forward kernel once, at
    rate 0 and seed 0 with its own weight, bias and eps: K5 at the text
    and image embedding tails, K3 at layer 0's two tails and at the
    ``BertLayerCLS`` tails (its residual a contiguous copy of the CLS
    row); the scores equal the plain path's (the same fp32 arithmetic on
    the CPU)."""
    from uniter_tpu_torch.models.encoder import LNDrop

    scorer, score = _scorer_inputs()
    with torch.inference_mode():
        plain = score()
    calls = _stand_in(monkeypatch)
    with torch.inference_mode():
        fused = score()
    tails = _tails(scorer)
    assert len(calls) == len(tails) == 6
    assert sorted(c[0] for c in calls) == ["drop_res_ln_fwd"] * 4 + [
        "ln_drop_fwd"] * 2
    for name, weight, bias, rate, seed, eps in calls:
        (tail,) = [t for t in tails if t.weight is weight]
        assert bias is tail.bias and eps == tail.eps
        assert (rate, seed) == (0.0, 0)
        assert (name == "ln_drop_fwd") == isinstance(tail, LNDrop)
    assert any(w is scorer.cls_layer.attention.output.LayerNorm.weight
               for _, w, *_ in calls)
    torch.testing.assert_close(fused, plain, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["grad", "mask", "refused"])
def test_tails_keep_the_plain_path_off_the_route(monkeypatch, case):
    """A forward that records gradients, one with live masks and
    ``block_fusion`` "none", and tensors ``_launchable`` refuses (the CPU's,
    as they are) call neither kernel and raise nothing; the refused
    forward scores as before."""
    scorer, score = _scorer_inputs()
    with torch.inference_mode():
        before = score()
    calls = _stand_in(monkeypatch, launchable=case != "refused")
    if case == "grad":
        out = score()
        assert out.requires_grad
    elif case == "mask":
        model = scorer.model
        model.train()
        with torch.no_grad():
            out = model.predict(dict(
                input_ids=torch.ones(2, 5, dtype=torch.int64),
                position_ids=torch.arange(5).repeat(2, 1),
                img_feat=torch.randn(2, 3, 16),
                img_pos_feat=torch.rand(2, 3, 7),
                attn_mask=torch.ones(2, 8, dtype=torch.int64)),
                deterministic=False,
                generator=torch.Generator().manual_seed(1))
        assert model.uniter.config.block_fusion == "none"
    else:
        with torch.inference_mode():
            out = score()
        torch.testing.assert_close(out, before, rtol=0, atol=0)
    assert calls == [] and torch.isfinite(out).all()


@pytest.mark.parametrize("launchable", [True, False])
def test_tails_count_their_route_in_a_trace_session(monkeypatch,
                                                    launchable):
    """Inside a profiler session each tail adds one ``tail.fused`` (the
    route launched) or one ``tail.plain`` (it did not); outside one the
    store does not change."""
    from torch.profiler import ProfilerActivity, profile

    from uniter_tpu_torch.utils import trace

    scorer, score = _scorer_inputs()
    _stand_in(monkeypatch, launchable)
    trace.count("off")
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.inference_mode():
            score()
    counts = trace.snapshot()["counts"]
    key = "tail.fused" if launchable else "tail.plain"
    assert counts == {key: len(_tails(scorer))}
    with torch.inference_mode():
        score()
    assert trace.snapshot()["counts"] == counts
