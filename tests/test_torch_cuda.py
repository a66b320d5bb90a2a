"""The port's CUDA kernels on the card (marker ``cuda``; they skip without a
CUDA device). The file imports torch and the port only, so it runs on a
machine without jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures jax for the CPU suite.)

K1 (``csrc/mha_fwd.cu``) is held against its plain version at the main
path's attention shape, fp32 (the TF32 kernel, three passes a product) to
1e-5 and bf16 (the bf16 tensor-core kernel, against fp32 on the same bf16
inputs) to 1e-2, at dropout rate 0 and 0.1 (same seed, so the same Philox
mask); at rate 0.1 the bf16 bound adds half a bf16 step of the value; rows
whose keys are all padding as tests/test_torch_attention.py explains; its
LSE to 1e-5 + 2**-20 |ref| (the fp32 grid near -10000), in fp32 the LSE
plus its remainder to 1e-5 of the float64 LSE. K2 (``csrc/mha_bwd.cu``),
one pass from K1's out and LSE in both dtypes: fp32 (with the LSE's
remainder) against ``_mha_bwd_lse_torch`` and the JAX kernel's formula
``_mha_bwd_torch`` to 1e-4 (another summation order over S and D); bf16
(with the output's remainder) against both in fp32 on the same bf16
inputs, out and LSE, to 2**-8 * |ref| + 1e-3 (one rounding of the result
to bf16, half a step, plus the hi/lo split's ~2**-16 and fp32 noise), at
the training shapes, with bitwise replay in both dtypes, fused-QKV strided
views, the copy of an fp32 view the kernels cannot stage, the refusal of a
misaligned bf16 view and of a K2 call without the forward's out and LSE.
A small VQA model answers the same through the kernels and through the
plain attention, and trains the same.

K3-K6 (``csrc/fused_tail.cu``) are held against their plain versions in
``ops/fused_block.py`` at rates 0 and 0.1 (same seed, so the same Philox
mask): fp32 forward to 1e-5; bf16 against the fp32 formula on the same bf16
inputs to half a bf16 step of the value + 1e-3; dx/dres as K2's; dw/db
(sums over rows in another order) to 1e-4 of their largest entry, bitwise
equal from run to run and to ``_sum_partials_torch`` of the kernels' own
block partials; at the embedding tails' shapes and at a width bf16 rows
take 4 at a time (772). The four wrappers captured in a CUDA graph replay
their eager results bit for bit; every refusal of ``_check`` on the card
is reached. A small VQA step through K1-K6 launches each fused tail once
per tail and matches the plain tails.

K7 (``csrc/ipot.cu``) is held against ``ops.ot.ipot`` at the pretraining
shapes, in all three of its forms and at their edges, with ragged and
all-padding examples, a joint padding that is not the outer OR of the
pads, a bf16 and a strided cost, lengths of 0 that the clamp lifts to 1,
and k = 1 and 2: the plan to 1e-5 + 1e-4 |ref| (fp32 rounding of other
summation orders through 50 dependent steps), exactly zero where it is
masked, bitwise equal from run to run; one call on contiguous fp32 inputs
runs one device kernel and nothing else. K8 (``uniter_layer_norm_fwd`` in
``csrc/fused_tail.cu``) against the plain ``layer_norm``: fp32 to 1e-5, bf16
to half a bf16 step of the value + 1e-3; a small pretraining model takes an
ITM step through K1-K8 with one K7 launch and matches the plain step.

K9 (``csrc/ffn.cu``) is held against ``ops.ffn.ffn_plain`` at chip_smoke.py's
K9_SHAPES and more (the retrieval and uniter-large widths, ragged row
counts, widths that are not multiples of 64, a partial last chunk): fp32
to 1e-5 of max(1, max|ref|), bf16 within two bf16 steps of |ref| + 1e-3
(fp32 sums in another order can re-round the intermediate), bitwise equal
from run to run and through either launch path, a second stream or a CUDA
graph; ``FfnFunction``'s backward is the plain formula; a small retrieval
model trains the same with K9 as without. K8 through its one-look launch
path equals K5 at rate 0 bit for bit.

Several processes (``uniter_tpu_torch/parallel``): a process group of one
NCCL rank, and of two gloo ranks sharing the card, runs the collectives on
CUDA tensors, and two train steps of a small VQA model through K1-K6
(dropout 0, the clip active), replicated and ``--fsdp``, give one
process's losses and parameters (1e-6). Three backward passes of a small
VQA model through K1-K6 give bit-equal gradients (the token-type table
read as a one-hot product).
"""

import pytest
import torch

from uniter_tpu_torch.config import resolve_kernel_policies, tiny_config
from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
from uniter_tpu_torch.ops import fused_block as fb
from uniter_tpu_torch.ops import layer_norm as ln
from uniter_tpu_torch.ops import ot
from uniter_tpu_torch.ops.attention import (
    MhaFunction, _mha_bwd_lse_torch, _mha_bwd_torch, _mha_torch, mha_bwd,
    mha_fwd)

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, b, s, h, d, dtype):
    """Random key lengths; rows 0 and 1 all padding, row 0 with a zero
    query (its result is exactly the uniform average of v)."""
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    q[0] = 0
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[:2] = 0
    mask = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    return q, k, v, (1.0 - mask.float()) * -10000.0


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,s", [(96, 104), (8, 512), (3, 13)])
def test_mha_kernel_matches_plain(gen, dtype, tol, b, s, rate):
    q, k, v, bias = _inputs(gen, b, s, 12, 64, dtype)
    before = mha_fwd.launches
    lse = torch.empty(b, 12, s, device="cuda") \
        if dtype == torch.bfloat16 else None
    out = mha_fwd(q, k, v, bias, rate, 1234, lse=lse)
    torch.cuda.synchronize()
    assert mha_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref, ref_lse = _mha_torch(q.float(), k.float(), v.float(), bias, rate,
                              1234, return_lse=True)
    if lse is not None:
        assert ((lse - ref_lse).abs() <= 1e-5 + 2.0**-20 * ref_lse.abs()).all()
    diff = (out.float() - ref).abs()
    if dtype == torch.bfloat16 and rate:
        # half a bf16 step at |ref| (the rescale by 1/(1-rate) lifts |out|
        # past 4, where that half step is 2**-6 > 1e-2); rate 0 keeps the
        # absolute 1e-2
        diff = diff - 2.0**-8 * ref.abs()
    assert torch.cat([diff[:1], diff[2:]]).max().item() <= tol
    assert diff[1].max().item() <= (2.0**-9 * v[1].float().abs().max()
                                    / (1.0 - rate) + tol)
    if rate:
        return
    uniform = v[0].float().mean(0)
    assert (out[0].float() - uniform).abs().max().item() <= tol


def test_mha_kernel_reads_strided_views(gen):
    """fused_qkv's q/k/v are strided views of one projection."""
    qkv = torch.randn(4, 40, 3 * 768, generator=gen, device="cuda")
    q, k, v = (qkv[..., i * 768:(i + 1) * 768].view(4, 40, 12, 64)
               for i in range(3))
    bias = torch.zeros(4, 40, device="cuda")
    out = mha_fwd(q, k, v, bias)
    ref = _mha_torch(q.contiguous(), k.contiguous(), v.contiguous(), bias)
    assert (out - ref).abs().max().item() <= 1e-5


def test_mha_kernel_rejects_mixed_devices(gen):
    q, k, v, bias = _inputs(gen, 2, 16, 2, 8, torch.float32)
    with pytest.raises(ValueError):
        mha_fwd(q, k, v, bias.cpu())


def test_vqa_model_through_kernel(gen):
    """Logits through K1 equal the plain attention's within 1e-4; each
    forward launches the kernel once per layer."""
    torch.manual_seed(0)
    cfg = tiny_config(attention_impl="pallas")
    model = UniterForVisualQuestionAnswering(
        resolve_kernel_policies(cfg, "cuda"), img_dim=32, num_answer=9)
    plain = UniterForVisualQuestionAnswering(
        resolve_kernel_policies(cfg, "cpu"), img_dim=32, num_answer=9)
    plain.load_state_dict(model.state_dict())
    model.cuda().eval()
    plain.cuda().eval()
    b, t, r = 6, 12, 10
    lens = torch.tensor([0, 3, 12, 7, 12, 5], device="cuda")
    attn = torch.cat([
        torch.arange(t, device="cuda")[None] < lens[:, None],
        torch.ones(b, r, dtype=torch.bool, device="cuda")], 1).int()
    batch = dict(
        input_ids=torch.randint(0, 512, (b, t), device="cuda"),
        position_ids=torch.arange(t, device="cuda").repeat(b, 1),
        img_feat=torch.randn(b, r, 32, generator=gen, device="cuda"),
        img_pos_feat=torch.rand(b, r, 7, generator=gen, device="cuda"),
        attn_mask=attn)
    before = mha_fwd.launches
    with torch.inference_mode():
        out = model.predict(batch)
        ref = plain.predict(batch)
    assert mha_fwd.launches == before + cfg.num_hidden_layers
    assert (out - ref).abs().max().item() <= 1e-4


def _bwd_inputs(gen, b, s, h, d, dtype):
    """Every query row but row 0 has a valid key; row 0 is all padding with
    a zero query (its scores are exactly -10000, so it is well conditioned;
    a random query there would sit on the fp32 grid at -10000)."""
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                  .to(dtype) for _ in range(4))
    q[0] = 0
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[0] = 0
    mask = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    return q, k, v, (1.0 - mask.float()) * -10000.0, g


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d", [(96, 104, 12, 64), (8, 512, 12, 64),
                                     (3, 13, 12, 64), (4, 70, 4, 128),
                                     (2, 33, 3, 8), (48, 224, 12, 64),
                                     (120, 128, 12, 64), (64, 172, 12, 64),
                                     (96, 104, 16, 64), (2, 512, 2, 128),
                                     (8, 352, 12, 64)])
def test_mha_bwd_kernel_matches_plain(gen, dtype, rate, b, s, h, d):
    """The one-pass K2 from K1's out and LSE (fp32: and the LSE's
    remainder; bf16: and the output's remainder) against
    ``_mha_bwd_lse_torch`` on the same inputs and against the JAX kernel's
    formula ``_mha_bwd_torch``: fp32 within 1e-4 of both, bf16 within
    2**-8 |ref| + 1e-3 (in bf16 (2, 512, 2, 128) keeps dQ in device
    memory: it does not fit in shared memory; in fp32 dQ is always there,
    and (8, 512, 12, 64), (4, 70, 4, 128) and (2, 512, 2, 128) split the
    keys into groups whose dQ is summed after)."""
    q, k, v, bias, g = _bwd_inputs(gen, b, s, h, d, dtype)
    lse = torch.empty(b, h, s, device="cuda")
    if dtype == torch.bfloat16:
        lo = torch.empty_like(q)
        key = "out_lo"
    else:
        lo = torch.empty_like(lse)
        key = "lse_lo"
    extra = {"out": mha_fwd(q, k, v, bias, rate, 77, lse=lse, **{key: lo}),
             "lse": lse, key: lo}
    before = mha_bwd.launches
    got = mha_bwd(q, k, v, bias, g, rate, 77, **extra)
    torch.cuda.synchronize()
    assert mha_bwd.launches == before + 1
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    if dtype == torch.float32:
        want = _mha_bwd_lse_torch(qf, kf, vf, bias, gf, extra["out"], lse,
                                  rate, 77, lse_lo=lo)
    else:
        want = _mha_bwd_lse_torch(
            qf, kf, vf, bias, gf, extra["out"].float() + lo.float(), lse,
            rate, 77)
    jax_formula = _mha_bwd_torch(qf, kf, vf, bias, gf, rate, 77)
    for name, x, ref, ref2 in zip(("dq", "dk", "dv"), got, want, jax_formula):
        assert x.dtype == dtype and x.shape == q.shape and x.is_contiguous()
        for r in (ref, ref2):
            diff = (x.float() - r).abs()
            if dtype == torch.float32:
                assert diff.max().item() <= 1e-4, name
            else:
                assert (diff <= 2.0**-8 * r.abs() + 1e-3).all(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,s,h,d", [(96, 104, 12, 64), (48, 224, 12, 64),
                                     (120, 128, 12, 64), (64, 172, 12, 64),
                                     (8, 512, 12, 64), (96, 104, 16, 64),
                                     (4, 70, 4, 128), (2, 33, 3, 8),
                                     (8, 352, 12, 64)])
def test_mha_tc_forward_matches_plain(gen, rate, b, s, h, d, dtype):
    """K1 at the training shapes against ``_mha_torch`` in fp32 on the same
    inputs, the LSE to 1e-5 + 2**-20 |ref|. bf16: the output to 1e-2 +
    2**-8 |ref|, out + out_lo (the fp32 output the backward's Di reads) to
    2**-14 max|ref| + 1e-5. fp32 (rows 0 and 1 all padding, row 1 with a
    random query): the output to 1e-5, row 1 to the grid bound 2**-9
    max|v| / (1 - rate) + 1e-5, and the LSE plus its remainder to 1e-5 of
    the float64 LSE (row 1 aside: its scores sit on the fp32 grid)."""
    lse = torch.empty(b, h, s, device="cuda")
    if dtype == torch.bfloat16:
        q, k, v, bias, _ = _bwd_inputs(gen, b, s, h, d, torch.bfloat16)
        lo = torch.empty_like(q)
        out = mha_fwd(q, k, v, bias, rate, 31, lse=lse, out_lo=lo)
    else:
        q, k, v, bias = _inputs(gen, b, s, h, d, torch.float32)
        lo = torch.empty_like(lse)
        out = mha_fwd(q, k, v, bias, rate, 31, lse=lse, lse_lo=lo)
    ref, ref_lse = _mha_torch(q.float(), k.float(), v.float(), bias, rate,
                              31, return_lse=True)
    assert ((lse - ref_lse).abs() <= 1e-5 + 2.0**-20 * ref_lse.abs()).all()
    if dtype == torch.bfloat16:
        assert ((out.float() - ref).abs() <= 2.0**-8 * ref.abs() + 1e-2).all()
        full = out.float() + lo.float()
        assert (full - ref).abs().max().item() <= \
            2.0**-14 * ref.abs().max().item() + 1e-5
        return
    diff = (out - ref).abs()
    assert torch.cat([diff[:1], diff[2:]]).max().item() <= 1e-5
    assert diff[1].max().item() <= (2.0**-9 * v[1].abs().max()
                                    / (1.0 - rate) + 1e-5)
    exact = _mha_torch(*(t.double() for t in (q, k, v, bias)),
                       return_lse=True)[1]
    e = (lse.double() + lo.double() - exact).abs()
    assert torch.cat([e[:1], e[2:]]).max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mha_tc_kernels_replay_bitwise(gen, rate, dtype):
    """K1 (out, LSE and the remainder: out_lo in bf16, lse_lo in fp32) and
    K2 repeat bit for bit: no atomics, no sums across blocks."""
    q, k, v, bias, g = _bwd_inputs(gen, 48, 224, 12, 64, dtype)
    key = "out_lo" if dtype == torch.bfloat16 else "lse_lo"
    runs = []
    for _ in range(2):
        lse = torch.empty(48, 12, 224, device="cuda")
        lo = torch.empty_like(q) if key == "out_lo" else torch.empty_like(lse)
        out = mha_fwd(q, k, v, bias, rate, 5, lse=lse, **{key: lo})
        runs.append((out, lse, lo, *mha_bwd(q, k, v, bias, g, rate, 5,
                                            out=out, lse=lse, **{key: lo})))
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def test_mha_fp32_kernels_copy_views_they_cannot_stage(gen):
    """The fp32 kernels stage rows by 16-byte cp.async; a view whose base
    or row stride is not a multiple of 4 floats is copied, never refused,
    and gives what a contiguous copy gives, bit for bit, forward and
    backward."""
    buf = torch.randn(2, 16, 4 * 64 + 2, generator=gen, device="cuda")
    q = buf[..., 2:].view(2, 16, 4, 64)  # base 8 bytes off
    k = buf[..., :256].view(2, 16, 4, 64)  # row stride 258 floats
    v = torch.randn(2, 16, 4, 64, generator=gen, device="cuda")
    g = torch.randn(2, 16, 4, 64, generator=gen, device="cuda")
    bias = torch.zeros(2, 16, device="cuda")
    bias[1, 10:] = -10000.0
    res = []
    for args in ((q, k, v), tuple(t.contiguous() for t in (q, k, v))):
        lse, lo = torch.empty(2, 4, 16, device="cuda"), \
            torch.empty(2, 4, 16, device="cuda")
        out = mha_fwd(*args, bias, 0.1, 3, lse=lse, lse_lo=lo)
        res.append((out, lse, lo, *mha_bwd(*args, bias, g, 0.1, 3, out=out,
                                           lse=lse, lse_lo=lo)))
    for x, y in zip(*res):
        assert torch.equal(x, y)


def test_mha_fp32_bwd_needs_the_forwards_out_and_lse(gen):
    """The one-pass fp32 K2 reads K1's out, LSE and the LSE's remainder: a
    call without them, or with the bf16 kernel's output remainder, is
    refused, with no fallback."""
    q, k, v, bias, g = _bwd_inputs(gen, 2, 16, 2, 8, torch.float32)
    lse, lo = torch.empty(2, 2, 16, device="cuda"), \
        torch.empty(2, 2, 16, device="cuda")
    out = mha_fwd(q, k, v, bias, lse=lse, lse_lo=lo)
    before = mha_bwd.launches
    for extra in ({}, {"out": out, "lse": lse},
                  {"out": out, "lse": lse, "lse_lo": lo,
                   "out_lo": q.bfloat16()}):
        with pytest.raises(ValueError):
            mha_bwd(q, k, v, bias, g, **extra)
    assert mha_bwd.launches == before
    with pytest.raises(ValueError):  # the fp32 K1 writes no output remainder
        mha_fwd(q, k, v, bias, out_lo=torch.empty_like(q).bfloat16())


def test_mha_tc_kernels_read_fused_qkv_views(gen):
    """fused_qkv's bf16 q/k/v are strided views of one projection (row
    stride 3 * 768): K1 and K2 read them as they are and give what they
    give on contiguous copies, bit for bit."""
    qkv = torch.randn(4, 40, 3 * 768, generator=gen, device="cuda").bfloat16()
    q, k, v = (qkv[..., i * 768:(i + 1) * 768].view(4, 40, 12, 64)
               for i in range(3))
    assert not q.is_contiguous()
    bias = torch.zeros(4, 40, device="cuda")
    bias[1, 30:] = -10000.0
    g = torch.randn(4, 40, 12, 64, generator=gen, device="cuda").bfloat16()
    res = []
    for args in ((q, k, v), tuple(t.contiguous() for t in (q, k, v))):
        lse, lo = torch.empty(4, 12, 40, device="cuda"), torch.empty_like(g)
        out = mha_fwd(*args, bias, 0.1, 3, lse=lse, out_lo=lo)
        res.append((out, lse, lo, *mha_bwd(*args, bias, g, 0.1, 3, out=out,
                                           lse=lse, out_lo=lo)))
    for x, y in zip(*res):
        assert torch.equal(x, y)


def test_mha_tc_kernels_refuse_misaligned_views(gen):
    """cp.async stages 16 bytes: a bf16 view whose base or row stride is not
    a multiple of 8 elements is refused, with no fallback; the bf16 K2
    needs the forward's out, LSE and output remainder."""
    buf = torch.randn(2, 16, 4 * 64 + 4, generator=gen,
                      device="cuda").bfloat16()
    q = buf[..., 4:].view(2, 16, 4, 64)  # base 8 bytes off
    k = v = buf[..., :256].view(2, 16, 4, 64)  # row stride 260 elements
    bias = torch.zeros(2, 16, device="cuda")
    for args in ((q, q.contiguous(), q.contiguous()),
                 (k, k.contiguous(), v.contiguous())):
        with pytest.raises(ValueError):
            mha_fwd(*args, bias)
    c = q.contiguous()
    with pytest.raises(ValueError):
        mha_bwd(c, c, c, bias, c)


def test_mha_function_grads_through_strided_views(gen):
    """fused_qkv's q/k/v are strided views of one projection; K2's
    gradients land in that projection's gradient through autograd."""
    qkv = torch.randn(4, 40, 3 * 768, generator=gen, device="cuda",
                      requires_grad=True)
    bias = torch.zeros(4, 40, device="cuda")
    bias[1, 30:] = -10000.0
    g = torch.randn(4, 40, 12, 64, generator=gen, device="cuda")

    def run(fn):
        qkv.grad = None
        q, k, v = (qkv[..., i * 768:(i + 1) * 768].view(4, 40, 12, 64)
                   for i in range(3))
        (fn(q, k, v) * g).sum().backward()
        return qkv.grad.clone()

    got = run(lambda q, k, v: MhaFunction.apply(q, k, v, bias, 0.1, 9))
    want = run(lambda q, k, v: _mha_torch(q, k, v, bias, 0.1, 9))
    assert (got - want).abs().max().item() <= 1e-4


def test_vqa_train_step_through_kernels(gen):
    """Loss and gradients of a small VQA model with live dropout (one
    generator seed for both) agree through the kernels and the plain
    attention; each step launches K1 and K2 once per layer."""
    from uniter_tpu_torch.train_vqa import vqa_loss

    torch.manual_seed(0)
    cfg = tiny_config(attention_impl="pallas")
    model = UniterForVisualQuestionAnswering(
        resolve_kernel_policies(cfg, "cuda"), img_dim=32, num_answer=9)
    plain = UniterForVisualQuestionAnswering(
        resolve_kernel_policies(cfg, "cpu"), img_dim=32, num_answer=9)
    plain.load_state_dict(model.state_dict())
    model.cuda()
    plain.cuda()
    b, t, r = 6, 12, 10
    lens = torch.tensor([1, 3, 12, 7, 12, 5], device="cuda")
    attn = torch.cat([
        torch.arange(t, device="cuda")[None] < lens[:, None],
        torch.ones(b, r, dtype=torch.bool, device="cuda")], 1).int()
    batch = dict(
        input_ids=torch.randint(0, 512, (b, t), device="cuda"),
        position_ids=torch.arange(t, device="cuda").repeat(b, 1),
        img_feat=torch.randn(b, r, 32, generator=gen, device="cuda"),
        img_pos_feat=torch.rand(b, r, 7, generator=gen, device="cuda"),
        attn_mask=attn,
        targets=(torch.rand(b, 9, generator=gen, device="cuda") < 0.3).float(),
        ex_weight=torch.ones(b, device="cuda"))
    f0, b0 = mha_fwd.launches, mha_bwd.launches
    losses, grads = [], []
    for m in (model, plain):
        loss = vqa_loss(m, batch, torch.Generator().manual_seed(3), 9)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in m.named_parameters()})
    assert mha_fwd.launches == f0 + cfg.num_hidden_layers
    assert mha_bwd.launches == b0 + cfg.num_hidden_layers
    assert abs(losses[0] - losses[1]) <= 1e-4 * max(1.0, abs(losses[1]))
    for n, gk in grads[0].items():
        gx = grads[1][n]
        assert (gk is None) == (gx is None), n  # mask_embedding: unused
        if gk is not None:
            assert (gk - gx).abs().max().item() <= 1e-4, n


def _close(x, ref, dtype, fp32_tol):
    diff = (x.float() - ref).abs()
    if dtype == torch.float32:
        return diff.max().item() <= fp32_tol
    return bool((diff <= 2.0**-8 * ref.abs() + 1e-3).all())


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,h", [(9984, 768), (91, 768), (9984, 1024),
                                    (7, 64), (6144, 768), (3840, 768),
                                    (33, 772)])
def test_fused_tail_kernels_match_plain(gen, dtype, rate, rows, h):
    x, res, g = (torch.randn(rows, h, generator=gen, device="cuda").to(dtype)
                 for _ in range(3))
    w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    b = 0.1 * torch.randn(h, generator=gen, device="cuda")
    xf, rf, gf = x.float(), res.float(), g.float()
    counts = [f.launches for f in (fb.drop_res_ln_fwd, fb.drop_res_ln_bwd,
                                   fb.ln_drop_fwd, fb.ln_drop_bwd)]
    y3 = fb.drop_res_ln_fwd(x, res, w, b, rate, 21)
    bwd4 = fb.drop_res_ln_bwd(x, res, w, g, rate, 21)
    y5 = fb.ln_drop_fwd(x, w, b, rate, 21)
    bwd6 = fb.ln_drop_bwd(x, w, g, rate, 21)
    torch.cuda.synchronize()
    assert [f.launches for f in (fb.drop_res_ln_fwd, fb.drop_res_ln_bwd,
                                 fb.ln_drop_fwd, fb.ln_drop_bwd)] == [
        c + 1 for c in counts]
    assert _close(y3, fb._drop_res_ln_torch(xf, rf, w, b, rate, 21), dtype,
                  1e-5)
    assert _close(y5, fb._ln_drop_torch(xf, w, b, rate, 21), dtype, 1e-5)
    want4 = fb._drop_res_ln_bwd_torch(xf, rf, w, gf, rate, 21)
    want6 = fb._ln_drop_bwd_torch(xf, w, gf, rate, 21)
    for got, want in ((bwd4, want4), (bwd6, want6)):
        n_act = len(got) - 2
        for x_, ref in zip(got[:n_act], want[:n_act]):
            assert x_.dtype == dtype and x_.shape == x.shape
            assert _close(x_, ref, dtype, 1e-4)
        for x_, ref in zip(got[n_act:], want[n_act:]):
            assert x_.dtype == torch.float32
            assert (x_ - ref).abs().max().item() <= 1e-4 * ref.abs().max()
    again = fb.drop_res_ln_bwd(x, res, w, g, rate, 21)
    assert torch.equal(again[2], bwd4[2]) and torch.equal(again[3], bwd4[3])
    again = fb.ln_drop_bwd(x, w, g, rate, 21)
    assert torch.equal(again[1], bwd6[1]) and torch.equal(again[2], bwd6[2])
    # dw/db are the fixed-order sum of the kernels' own block partials
    for r, want in ((res, bwd4), (None, bwd6)):
        _, _, part, dwdb = fb._tail_bwd(x, r, w, g, rate, 21, 1e-12)
        assert torch.equal(dwdb, fb._sum_partials_torch(part))
        assert torch.equal(dwdb[0], want[-2]) and torch.equal(dwdb[1], want[-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_tails_replay_in_a_cuda_graph(gen, dtype):
    """The four tail wrappers captured in one CUDA graph (the launches go
    to the capture stream, the outputs come from the graph's pool): the
    replay gives the eager results bit for bit."""
    rows, h = 96 * 40, 768
    x, res, g = (torch.randn(rows, h, generator=gen, device="cuda").to(dtype)
                 for _ in range(3))
    w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    b = 0.1 * torch.randn(h, generator=gen, device="cuda")

    def tails():
        return (fb.drop_res_ln_fwd(x, res, w, b, 0.1, 9),
                *fb.drop_res_ln_bwd(x, res, w, g, 0.1, 9),
                fb.ln_drop_fwd(x, w, b, 0.1, 9),
                *fb.ln_drop_bwd(x, w, g, 0.1, 9))

    eager = tails()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        tails()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tails()
    graph.replay()
    torch.cuda.synchronize()
    assert len(captured) == len(eager) == 9
    for got, want in zip(captured, eager):
        assert torch.equal(got, want)


def test_fused_tails_refuse_on_the_card(gen):
    x = torch.randn(4, 6, device="cuda")
    w, b = torch.ones(6, device="cuda"), torch.zeros(6, device="cuda")
    with pytest.raises(ValueError):  # H % 4
        fb.ln_drop_fwd(x, w, b)
    x = torch.randn(8, 4, device="cuda").t()
    w, b = torch.ones(8, device="cuda"), torch.zeros(8, device="cuda")
    with pytest.raises(ValueError):  # not contiguous
        fb.ln_drop_fwd(x, w, b)
    x = torch.randn(4, 1028, device="cuda")
    w, b = torch.ones(1028, device="cuda"), torch.zeros(1028, device="cuda")
    with pytest.raises(ValueError):  # H > 1024
        fb.drop_res_ln_fwd(x, x, w, b)
    x = torch.randn(4 * 768 + 2, device="cuda")[2:].view(4, 768)
    w, b = torch.ones(768, device="cuda"), torch.zeros(768, device="cuda")
    with pytest.raises(ValueError):  # 8 bytes off 16-byte alignment
        fb.ln_drop_bwd(x, w, torch.ones_like(x))
    x = torch.randn(4, 768, device="cuda")
    with pytest.raises(ValueError):  # a weight view with a stride
        fb.ln_drop_fwd(x, torch.ones(2 * 768, device="cuda")[::2], b)
    with pytest.raises(ValueError):  # two devices
        fb.drop_res_ln_bwd(x, x, w.cpu(), x)
    with pytest.raises(TypeError):  # float16 activations
        fb.ln_drop_fwd(x.half(), w, b)
    with pytest.raises(TypeError):  # float64 on the card
        fb.ln_drop_fwd(x.double(), w.double(), b.double())
    with pytest.raises(TypeError):  # bf16 weights
        fb.drop_res_ln_fwd(x.bfloat16(), x.bfloat16(), w.bfloat16(), b)
    with pytest.raises(ValueError):  # rate
        fb.drop_res_ln_fwd(x, x, w, b, 1.0, 3)
    before = fb.ln_drop_fwd.launches
    fb.ln_drop_fwd(x, w, b)  # what is right still launches
    assert fb.ln_drop_fwd.launches == before + 1


def test_vqa_train_step_through_fused_tails(gen):
    """A small VQA step at dropout 0.1 through K1-K6 (block_fusion
    resolved from "auto" for training on the card) against the plain
    tails, same generator seed: loss and gradients within 1e-4; each step
    launches K3/K4 at the 2 sub-block tails of each layer and K5/K6 at the
    2 embedding tails."""
    from uniter_tpu_torch.train_vqa import vqa_loss

    torch.manual_seed(0)
    cfg = tiny_config(attention_impl="pallas", block_fusion="auto")
    fused_cfg = resolve_kernel_policies(cfg, "cuda", training=True)
    assert fused_cfg.block_fusion == "cuda"
    model = UniterForVisualQuestionAnswering(fused_cfg, img_dim=32,
                                             num_answer=9)
    plain = UniterForVisualQuestionAnswering(
        fused_cfg.replace(block_fusion="none"), img_dim=32, num_answer=9)
    plain.load_state_dict(model.state_dict())
    model.cuda()
    plain.cuda()
    b, t, r = 6, 12, 10
    lens = torch.tensor([1, 3, 12, 7, 12, 5], device="cuda")
    attn = torch.cat([
        torch.arange(t, device="cuda")[None] < lens[:, None],
        torch.ones(b, r, dtype=torch.bool, device="cuda")], 1).int()
    batch = dict(
        input_ids=torch.randint(0, 512, (b, t), device="cuda"),
        position_ids=torch.arange(t, device="cuda").repeat(b, 1),
        img_feat=torch.randn(b, r, 32, generator=gen, device="cuda"),
        img_pos_feat=torch.rand(b, r, 7, generator=gen, device="cuda"),
        attn_mask=attn,
        targets=(torch.rand(b, 9, generator=gen, device="cuda") < 0.3).float(),
        ex_weight=torch.ones(b, device="cuda"))
    kernels = (fb.drop_res_ln_fwd, fb.drop_res_ln_bwd, fb.ln_drop_fwd,
               fb.ln_drop_bwd)
    before = [k.launches for k in kernels]
    losses, grads = [], []
    for m in (model, plain):
        loss = vqa_loss(m, batch, torch.Generator().manual_seed(3), 9)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in m.named_parameters()})
    n_layers = cfg.num_hidden_layers
    assert [k.launches - c for k, c in zip(kernels, before)] == [
        2 * n_layers, 2 * n_layers, 2, 2]
    assert abs(losses[0] - losses[1]) <= 1e-4 * max(1.0, abs(losses[1]))
    for n, gk in grads[0].items():
        gx = grads[1][n]
        assert (gk is None) == (gx is None), n
        if gk is not None:
            assert (gk - gx).abs().max().item() <= 1e-4, n


def _ot_inputs(gen, b, n, m, all_pad=()):
    """A cosine-like cost [B, M, N] in [0, 2], ragged valid lengths, the
    examples in ``all_pad`` all padding."""
    cost = 2.0 * torch.rand(b, m, n, generator=gen, device="cuda")
    x_len = torch.randint(1, m + 1, (b,), generator=gen, device="cuda")
    y_len = torch.randint(1, n + 1, (b,), generator=gen, device="cuda")
    for i in all_pad:
        x_len[i] = y_len[i] = 0
    x_pad = torch.arange(m, device="cuda")[None, :] >= x_len[:, None]
    y_pad = torch.arange(n, device="cuda")[None, :] >= y_len[:, None]
    joint = x_pad[:, :, None] | y_pad[:, None, :]
    return (cost.masked_fill(joint, 0.0), x_len.float(), x_pad,
            y_len.float(), y_pad, joint)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("b,n,m,form", [
    (48, 64, 160, 0), (96, 40, 64, 0), (64, 100, 64, 0), (8, 100, 512, 1),
    (4, 200, 512, 2), (5, 37, 23, 0)])
def test_ipot_kernel_matches_plain(gen, b, n, m, form, k):
    assert ot.ipot_form(n, m) == form
    args = _ot_inputs(gen, b, n, m, all_pad=(1, b - 1))
    before = ot.ipot_cuda.launches
    got = ot.ipot_cuda(*args, 0.5, 50, k)
    torch.cuda.synchronize()
    assert ot.ipot_cuda.launches == before + 1
    want = ot.ipot(*args, 0.5, 50, k)
    assert got.shape == (b, n, m) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    excess = (got - want).abs() - (1e-5 + 1e-4 * want.abs())
    assert excess.max().item() <= 0
    assert (got[args[5].transpose(1, 2)] == 0).all()
    assert (got[1] == 0).all() and (got[b - 1] == 0).all()
    assert torch.equal(got, ot.ipot_cuda(*args, 0.5, 50, k))


def test_ipot_kernel_through_the_distance(gen):
    """``optimal_transport_dist`` with impl "cuda" against "xla" on the
    same embeddings (rtol 1e-4); gradients flow through the cost alone."""
    b, m, n, d = 16, 60, 36, 768
    x = torch.randn(b, m, d, generator=gen, device="cuda", requires_grad=True)
    y = torch.randn(b, n, d, generator=gen, device="cuda", requires_grad=True)
    x_pad = torch.arange(m, device="cuda")[None, :] >= torch.randint(
        2, m + 1, (b, 1), generator=gen, device="cuda")
    y_pad = torch.arange(n, device="cuda")[None, :] >= torch.randint(
        2, n + 1, (b, 1), generator=gen, device="cuda")
    got = ot.optimal_transport_dist(x, y, x_pad, y_pad, impl="cuda")
    want = ot.optimal_transport_dist(x, y, x_pad, y_pad, impl="xla")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    gx, gy = torch.autograd.grad(got.sum(), (x, y))
    wx, wy = torch.autograd.grad(want.sum(), (x, y))
    torch.testing.assert_close(gx, wx, rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(gy, wy, rtol=1e-3, atol=1e-6)


def _hold_k7(args, k):
    """K7 against ``ipot`` on the same inputs: 1e-5 + 1e-4 |ref|, exact
    zeros at joint padding, a bitwise repeat. Returns the plan."""
    got = ot.ipot_cuda(*args, 0.5, 50, k)
    torch.cuda.synchronize()
    want = ot.ipot(*args, 0.5, 50, k)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    excess = (got - want).abs() - (1e-5 + 1e-4 * want.abs())
    assert excess.max().item() <= 0
    assert (got[args[5].transpose(1, 2)] == 0).all()
    assert torch.equal(got, ot.ipot_cuda(*args, 0.5, 50, k))
    return got


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("b,n,m,form", [
    (6, 128, 160, 0), (6, 129, 160, 1), (6, 128, 161, 1), (3, 100, 544, 1),
    (3, 100, 545, 2)])
def test_ipot_kernel_at_the_forms_edges(gen, b, n, m, form, k):
    """The largest register-form plan, plans one row or one column past it,
    and the largest form-1 plan at N = 100 and one column past it."""
    assert ot.ipot_form(n, m) == form
    got = _hold_k7(_ot_inputs(gen, b, n, m, all_pad=(1,)), k)
    assert (got[1] == 0).all()


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("b,n,m", [(48, 64, 160), (5, 37, 23),
                                   (4, 100, 512)])
def test_ipot_kernel_reads_joint_padding_as_given(gen, b, n, m, k):
    """A joint padding wider than the outer OR of the pads (every valid row
    and column keeps its first entry, so no valid sum is empty): the plan
    is zero exactly there, and the kernel agrees with ``ipot``."""
    cost, x_len, x_pad, y_len, y_pad, joint = _ot_inputs(gen, b, n, m,
                                                         all_pad=(1,))
    extra = torch.rand(b, m, n, generator=gen, device="cuda") < 0.3
    extra[:, 0, :] = False
    extra[:, :, 0] = False
    args = (cost, x_len, x_pad, y_len, y_pad, joint | extra)
    assert (args[5] != joint).any()
    _hold_k7(args, k)


@pytest.mark.parametrize("case", ["bf16", "strided", "zero_lengths"])
def test_ipot_kernel_takes_what_the_wrapper_fixes(gen, case):
    """A bf16 cost (cast to fp32 by the wrapper), a transposed view of the
    cost (copied), lengths of 0 where one side of an example is all padding
    and the other is not (the clamp lifts them to 1; inside the kernel the
    example's sums are empty and its vectors not finite, and the plan is
    still exactly zero there), at the pretraining bucket and in form 1."""
    for b, n, m in ((48, 64, 160), (4, 100, 512)):
        cost, x_len, x_pad, y_len, y_pad, joint = _ot_inputs(
            gen, b, n, m, all_pad=(1,))
        if case == "bf16":
            cost = cost.bfloat16()
        elif case == "strided":
            cost = cost.transpose(1, 2).contiguous().transpose(1, 2)
            assert not cost.is_contiguous()
        else:
            x_pad, y_pad = x_pad.clone(), y_pad.clone()
            x_pad[0], y_pad[2] = True, True
            x_len = (~x_pad).sum(1).float()
            y_len = (~y_pad).sum(1).float()
            joint = x_pad[:, :, None] | y_pad[:, None, :]
            cost = cost.masked_fill(joint, 0.0)
        got = _hold_k7((cost, x_len, x_pad, y_len, y_pad, joint), 1)
        if case == "zero_lengths":
            assert (got[0] == 0).all() and (got[2] == 0).all()


def _graph_nodes(fn):
    """The nodes one call of ``fn`` puts on its stream, from a CUDA graph
    captured from it, read through libcuda: kernel nodes as their function's
    name, any other node as its type number."""
    import ctypes

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t()
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    found = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            found.append(kind.value)
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: the CUfunction first, the CUkernel
        # at the eighth pointer, whichever the launch left
        params = (ctypes.c_void_p * 16)()
        assert cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                params) == 0
        name = ctypes.c_char_p()
        if params[0]:
            assert cu.cuFuncGetName(ctypes.byref(name),
                                    ctypes.c_void_p(params[0])) == 0
        else:
            assert cu.cuKernelGetName(ctypes.byref(name),
                                      ctypes.c_void_p(params[7])) == 0
        found.append(name.value.decode())
    return found


@pytest.mark.parametrize("b,n,m", [(48, 64, 160), (8, 100, 512),
                                   (4, 200, 512)])
def test_ipot_kernel_is_one_device_kernel_a_call(gen, b, n, m):
    """On contiguous fp32 inputs, as ``optimal_transport_dist`` makes them,
    a call puts K7 on its stream and nothing else: no cast, copy or
    re-mask (a count of the nodes of a CUDA graph captured from the call);
    on the host it runs no torch operation but the allocations."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    args = _ot_inputs(gen, b, n, m)
    before = ot.ipot_cuda.launches
    nodes = _graph_nodes(lambda: ot.ipot_cuda(*args, 0.5, 50, 1))
    assert ot.ipot_cuda.launches == before + 2
    assert len(nodes) == 1, nodes
    kernel = "ipot_reg_kernel" if ot.ipot_form(n, m) == 0 else "ipot_mem"
    assert kernel in nodes[0], nodes
    with Ops() as ops:
        ot.ipot_cuda(*args, 0.5, 50, 1)
    assert ops.seen and set(ops.seen) == {"aten.empty.memory_format"}, \
        ops.seen


def test_ipot_kernel_refuses_on_the_card(gen):
    args = list(_ot_inputs(gen, 2, 8, 8))
    with pytest.raises(ValueError, match="x_len"):
        ot.ipot_cuda(args[0], args[1].cpu(), *args[2:], 0.5, 50, 1)
    with pytest.raises(ValueError, match="k >= 1"):
        ot.ipot_cuda(*args, 0.5, 50, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,h", [(9984, 768), (91, 768), (9984, 1024),
                                    (96, 1536), (7, 2048), (33, 64)])
def test_layer_norm_kernel_matches_plain(gen, dtype, rows, h):
    x = (2.0 * torch.randn(rows, h, generator=gen, device="cuda")
         + 0.5).to(dtype)
    w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    b = 0.1 * torch.randn(h, generator=gen, device="cuda")
    before = ln.layer_norm_fwd.launches
    got = ln.layer_norm_fwd(x, w, b, 1e-12)
    torch.cuda.synchronize()
    assert ln.layer_norm_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = ln._layer_norm_torch(x.float(), w, b, 1e-12)
    tol = (1e-5 if dtype == torch.float32
           else 2.0**-8 * want.abs() + 1e-3)
    assert ((got.float() - want).abs() - tol).max().item() <= 0
    # w and b at any 4-byte offset of a flat buffer, as AdamW keeps them
    flat = torch.cat([w.new_zeros(1), w, b])
    assert torch.equal(
        got, ln.layer_norm_fwd(x, flat[1:1 + h], flat[1 + h:], 1e-12))
    # the one-look launch path, and K5's row code: K5 at rate 0 is K8 bit
    # for bit where it takes the width
    assert ln._fits(x, w, b)
    if h <= fb.MAX_HIDDEN:
        assert torch.equal(got, fb.ln_drop_fwd(x, w, b, 0.0, 0, 1e-12))


def test_layer_norm_function_on_the_card(gen):
    """K8 forward, plain backward, against autograd of the plain version;
    a 3-d strided input is made contiguous; what the kernel cannot take
    raises."""
    x = torch.randn(6, 40, 2 * 768, generator=gen, device="cuda")[..., ::2]
    x = x.bfloat16().requires_grad_()
    w = (1.0 + 0.1 * torch.randn(768, generator=gen, device="cuda")
         ).requires_grad_()
    b = torch.zeros(768, device="cuda", requires_grad=True)
    g = torch.randn(6, 40, 768, generator=gen, device="cuda").bfloat16()
    before = ln.layer_norm_fwd.launches
    got = torch.autograd.grad(ln.layer_norm(x, w, b, 1e-12, impl="cuda"),
                              (x, w, b), g)
    assert ln.layer_norm_fwd.launches == before + 1
    want = torch.autograd.grad(ln.layer_norm(x, w, b, 1e-12, impl="xla"),
                               (x, w, b), g)
    for a, r in zip(got, want):
        assert a.dtype == r.dtype
        bound = 2.0**-7 * r.float().abs() + 1e-3 * r.float().abs().max()
        assert ((a.float() - r.float()).abs() - bound).max().item() <= 0
    with pytest.raises(ValueError, match="multiple of 4 up to 2048"):
        ln.layer_norm_fwd(torch.zeros(4, 4096, device="cuda"),
                          torch.ones(4096, device="cuda"),
                          torch.zeros(4096, device="cuda"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ln.layer_norm_fwd(torch.zeros(4, 64, device="cuda").half(),
                          torch.ones(64, device="cuda"),
                          torch.zeros(64, device="cuda"))


def test_pretrain_itm_step_through_kernels(gen):
    """A small pretraining model, fp32, dropout 0.1: the ITM step through
    K1-K8 (one K7 launch, K8 at the image embeddings) against the plain
    step with the same masks; the MLM step launches no K7."""
    import numpy as np

    from uniter_tpu_torch.models.pretrain import UniterForPretraining
    from uniter_tpu_torch.training.optim import build_optimizer
    from uniter_tpu_torch.training.step import TrainState, make_train_step

    cfg = tiny_config(hidden_size=64, num_attention_heads=4,
                      attention_impl="auto", block_fusion="auto",
                      layer_norm_impl="pallas")
    torch.manual_seed(0)
    ref = UniterForPretraining(tiny_config(), img_dim=32, img_label_dim=11)
    rng = np.random.RandomState(0)
    b, t, r = 6, 12, 8
    attn = np.ones((b, t + r), np.int64)
    attn[0, t - 4:t] = 0
    attn[1, t + r - 3:] = 0
    attn[b - 1] = 0
    batch = {k: torch.from_numpy(v).cuda() for k, v in dict(
        input_ids=rng.randint(1, 500, (b, t)),
        position_ids=np.tile(np.arange(t), (b, 1)),
        img_feat=rng.randn(b, r, 32).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=attn,
        targets=np.array([1, 0, 1, 0, 1, -1]),
        mlm_pos=rng.randint(0, t, (b, 3)),
        mlm_tgt=rng.randint(1, 500, (b, 3))).items()}
    out = {}
    for name, c, ot_impl in (
            ("kernels", resolve_kernel_policies(cfg, "cuda", training=True),
             "cuda"),
            ("plain", resolve_kernel_policies(tiny_config(), "cuda",
                                              training=True), "xla")):
        model = UniterForPretraining(c, img_dim=32, img_label_dim=11,
                                     ot_impl=ot_impl)
        model.load_state_dict(ref.state_dict(), strict=True)
        model.cuda()
        state = TrainState(step=0, model=model,
                           opt=build_optimizer(model, 1e-3, fused=True))
        steps = {task: make_train_step(
            lambda m, bt, g, _t=task: m.scalar_loss(
                bt, _t, ot_lambda=0.1 if _t == "itm" else 0.0,
                deterministic=False, generator=g))
            for task in ("itm", "mlm")}
        k7, k8 = ot.ipot_cuda.launches, ln.layer_norm_fwd.launches
        _, m1 = steps["itm"](state, batch, 5)
        k7_itm = ot.ipot_cuda.launches - k7
        _, m2 = steps["mlm"](state, batch, 5)
        out[name] = (float(m1["loss"]), float(m1["itm_ot"]),
                     float(m2["loss"]), k7_itm,
                     ot.ipot_cuda.launches - k7 - k7_itm,
                     ln.layer_norm_fwd.launches - k8)
    assert out["kernels"][3:5] == (1, 0) and out["kernels"][5] > 0
    assert out["plain"][3:] == (0, 0, 0)
    for a, c in zip(out["kernels"][:3], out["plain"][:3]):
        assert abs(a - c) <= 1e-4 * abs(c) + 1e-6


def _ffn_inputs(gen, rows, d_in, d_mid, d_out, dtype):
    x = torch.randn(rows, d_in, generator=gen, device="cuda").to(dtype)
    w1 = (0.02 * torch.randn(d_mid, d_in, generator=gen, device="cuda")
          ).to(dtype)
    w2 = (0.02 * torch.randn(d_out, d_mid, generator=gen, device="cuda")
          ).to(dtype)
    b1 = 0.1 * torch.randn(d_mid, generator=gen, device="cuda")
    b2 = 0.1 * torch.randn(d_out, generator=gen, device="cuda")
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d_in,d_mid,d_out", [
    (2048, 768, 3072, 768), (1024, 1024, 4096, 1024), (97, 768, 3072, 768),
    (33, 64, 144, 48),
    # chip_smoke.py K9_SHAPES: the retrieval step, the flagship rows,
    # uniter-large widths, a ragged row count
    (15360, 768, 3072, 768), (9984, 768, 3072, 768),
    (9984, 1024, 4096, 1024), (4097, 768, 3072, 768),
    # D_in and D_mid not multiples of 64, D_out not a multiple of 128
    (130, 784, 400, 80)])
def test_ffn_kernel_matches_plain(gen, dtype, rows, d_in, d_mid, d_out):
    """K9 against ``ffn_plain``: fp32 to 1e-5 of max(1, max|ref|) (another
    summation order), bf16 within two bf16 steps of |ref| + 1e-3 (fp32 sums
    in another order can re-round the intermediate); bitwise equal from
    run to run; ragged row counts and a partial last D_mid chunk."""
    from uniter_tpu_torch.ops.ffn import ffn_fwd, ffn_plain

    args = _ffn_inputs(gen, rows, d_in, d_mid, d_out, dtype)
    before = ffn_fwd.launches
    got = ffn_fwd(*args)
    torch.cuda.synchronize()
    assert ffn_fwd.launches == before + 1
    want = ffn_plain(*args).float()
    diff = (got.float() - want).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-5 * max(1.0, want.abs().max().item())
    else:
        assert (diff - (2.0**-6 * want.abs() + 1e-3)).max().item() <= 0
    assert got.dtype == dtype and got.shape == (rows, d_out)
    assert torch.equal(got, ffn_fwd(*args))


def test_ffn_function_on_the_card(gen):
    """K9 forward, the plain fp32 backward, against autograd of the plain
    version's formula; what the kernel cannot take raises."""
    from uniter_tpu_torch.ops.ffn import (
        FfnFunction, _ffn_bwd_torch, ffn_fwd, ffn_plain)

    x, w1, b1, w2, b2 = (t.requires_grad_() for t in _ffn_inputs(
        gen, 300, 768, 3072, 768, torch.bfloat16))
    g = torch.randn(300, 768, generator=gen, device="cuda").bfloat16()
    got = torch.autograd.grad(FfnFunction.apply(x, w1, b1, w2, b2),
                              (x, w1, b1, w2, b2), g)
    want = _ffn_bwd_torch(x, w1, b1, w2, b2, g)
    for a, r, t in zip(got, want, (x, w1, b1, w2, b2)):
        assert a.dtype == t.dtype and torch.equal(a, r)
    ref = torch.autograd.grad(ffn_plain(x.float(), w1.float(), b1, w2.float(),
                                        b2), (x, w1, b1, w2, b2), g.float())
    for a, r in zip(got, ref):
        bound = 2.0**-7 * r.float().abs() + 1e-3 * r.float().abs().max()
        assert ((a.float() - r.float()).abs() - bound).max().item() <= 0
    z = torch.zeros(64, 2048, device="cuda")
    with pytest.raises(ValueError, match="<= 1024"):
        ffn_fwd(z, torch.zeros(64, 2048, device="cuda"),
                torch.zeros(64, device="cuda"),
                torch.zeros(2048, 64, device="cuda"),
                torch.zeros(2048, device="cuda"))
    x, w1, b1, w2, b2 = _ffn_inputs(gen, 8, 64, 128, 64, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ffn_fwd(x.half(), w1.half(), b1, w2.half(), b2)
    with pytest.raises(ValueError, match="contiguous"):
        ffn_fwd(x.t().contiguous().t(), w1, b1, w2, b2)
    with pytest.raises(TypeError, match="weights"):
        ffn_fwd(x, w1.bfloat16(), b1, w2, b2)
    with pytest.raises(ValueError, match="<= 1024"):  # D_out 1040
        ffn_fwd(*_ffn_inputs(gen, 8, 64, 128, 1040, torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_short_and_full_launch_paths_agree(gen, dtype):
    """The one-look path (``_fits``) and the full checks with their copies
    (a tensor off a 16-byte boundary, biases in float64) launch the same
    kernel on the same values: equal results, one launch each; the launch
    on a second stream and captured in a CUDA graph repeats them too."""
    from uniter_tpu_torch.ops import ffn

    x, w1, b1, w2, b2 = _ffn_inputs(gen, 300, 768, 3072, 768, dtype)
    assert ffn._fits(x, w1, b1, w2, b2)
    want = ffn.ffn_fwd(x, w1, b1, w2, b2)

    def off(t):  # t's values 4 bytes past a 16-byte boundary
        flat = torch.empty(t.numel() + 8, dtype=t.dtype, device="cuda")
        return flat[2:2 + t.numel()].view(t.shape).copy_(t)

    before = ffn.ffn_fwd.launches
    for args in ((off(x), w1, b1, w2, b2), (x, off(w1), b1, off(w2), b2),
                 (x, w1, b1.double(), w2, b2)):
        assert torch.equal(ffn.ffn_fwd(*args), want)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        got = ffn.ffn_fwd(x, w1, b1, w2, b2)
    torch.cuda.current_stream().wait_stream(s)
    assert torch.equal(got, want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ffn.ffn_fwd(x, w1, b1, w2, b2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, want)
    assert ffn.ffn_fwd.launches == before + 5


def test_retrieval_step_through_ffn_kernel(gen):
    """A small retrieval model, fp32, dropout 0.1: one train step with
    ``ffn_impl="pallas"`` (K9 once per layer, with K1-K6) against the same
    step with the unfused FFN, losses to 1e-5 relative."""
    import numpy as np

    from uniter_tpu_torch.models.itm import UniterForImageTextRetrieval
    from uniter_tpu_torch.ops.ffn import ffn_fwd
    from uniter_tpu_torch.train_itm import rank_loss
    from uniter_tpu_torch.training.optim import build_optimizer
    from uniter_tpu_torch.training.step import TrainState, make_train_step

    torch.manual_seed(0)
    base = tiny_config(hidden_size=64, num_hidden_layers=3,
                       num_attention_heads=4, intermediate_size=256,
                       attention_impl="auto", block_fusion="auto")
    ref = UniterForImageTextRetrieval(base, img_dim=32)
    rng = np.random.RandomState(0)
    rows, t, r = 12, 10, 6
    attn = np.ones((rows, t + r), np.int64)
    attn[0, t - 4:t] = 0
    batch = {k: torch.from_numpy(v).cuda() for k, v in dict(
        input_ids=rng.randint(1, 500, (rows, t)),
        position_ids=np.tile(np.arange(t), (rows, 1)),
        img_feat=rng.randn(rows, r, 32).astype(np.float32),
        img_pos_feat=rng.rand(rows, r, 7).astype(np.float32),
        attn_mask=attn, ex_weight=np.ones(rows, np.float32)).items()}
    losses = {}
    for ffn_impl in ("pallas", "xla"):
        cfg = resolve_kernel_policies(base.replace(ffn_impl=ffn_impl),
                                      "cuda", training=True)
        model = UniterForImageTextRetrieval(cfg, img_dim=32)
        model.load_state_dict(ref.state_dict(), strict=True)
        model.cuda()
        state = TrainState(step=0, model=model,
                           opt=build_optimizer(model, 1e-3, fused=True))
        step = make_train_step(lambda m, b, g: (rank_loss(m, b, g, 3), {}))
        before = ffn_fwd.launches
        losses[ffn_impl] = [float(step(state, batch, 3)[1]["loss"])
                            for _ in range(2)]
        assert ffn_fwd.launches - before == (6 if ffn_impl == "pallas" else 0)
    for a, c in zip(losses["pallas"], losses["xla"]):
        assert abs(a - c) <= 1e-5 * abs(c) + 1e-6


def test_re_rank_sampler_on_the_card(gen):
    """``sample_neg`` on CUDA tensors with a CUDA generator: the hard
    negative is the argmax without the target, easy ones are never the
    target or padding, the hard share is ``hard_ratio`` within 0.02 where
    the two differ, one seed gives one draw; an RE model's rank loss
    replays from the step's generator on the card."""
    from uniter_tpu_torch.models.re import (
        NEG_FILL, UniterForReferringExpressionComprehension, sample_neg)
    from uniter_tpu_torch.training.step import step_generator

    b, n = 20000, 100
    targets = torch.randint(0, 10, (b,), generator=gen, device="cuda")
    n_valid = torch.maximum(
        torch.randint(2, n + 1, (b,), generator=gen, device="cuda"),
        targets + 2)
    masks = torch.arange(n, device="cuda")[None] >= n_valid[:, None]
    scores = torch.randn(b, n, generator=gen, device="cuda").masked_fill(
        masks, NEG_FILL)

    def draw(ratio, seed):
        return sample_neg(scores, targets, masks, ratio,
                          torch.Generator("cuda").manual_seed(seed))

    hard = scores.masked_fill(
        torch.nn.functional.one_hot(targets, n).bool(),
        float("-inf")).argmax(-1)
    assert torch.equal(draw(1.0, 0), hard)
    easy = draw(0.0, 0)
    assert easy.is_cuda and not (easy == targets).any()
    assert not masks.gather(1, easy[:, None]).any()
    mixed = draw(0.3, 0)
    assert torch.equal(draw(0.3, 0), mixed)
    assert not torch.equal(draw(0.3, 1), mixed)
    differ = easy != hard
    share = float((mixed[differ] == hard[differ]).float().mean())
    assert abs(share - 0.3) < 0.02, share

    cfg = resolve_kernel_policies(tiny_config(hidden_dropout_prob=0.1,
                                              attention_probs_dropout_prob=0.1),
                                  "cuda", training=True)
    torch.manual_seed(0)
    model = UniterForReferringExpressionComprehension(
        cfg, img_dim=32, loss_type="rank").cuda().train()
    g = torch.Generator("cuda").manual_seed(1)
    batch = {"input_ids": torch.randint(1, 500, (8, 16), generator=g,
                                        device="cuda"),
             "position_ids": torch.arange(16, device="cuda").expand(8, 16),
             "img_feat": torch.randn(8, 24, 32, generator=g, device="cuda"),
             "img_pos_feat": torch.rand(8, 24, 7, generator=g,
                                        device="cuda"),
             "attn_mask": torch.ones(8, 40, dtype=torch.int32,
                                     device="cuda"),
             "targets": torch.arange(8, device="cuda")}
    a = model(batch, True, deterministic=False,
              generator=step_generator(5, 2))
    b2 = model(batch, True, deterministic=False,
               generator=step_generator(5, 2))
    assert torch.isfinite(a).all() and torch.equal(a, b2)


# ---------------------------------------------------- several processes

DIST_CODE = r"""
import os, sys
import numpy as np, torch
from uniter_tpu_torch.parallel import collectives as C
from uniter_tpu_torch.config import resolve_kernel_policies, tiny_config
from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
from uniter_tpu_torch.train_vqa import vqa_loss
from uniter_tpu_torch.training.optim import build_optimizer
from uniter_tpu_torch.training.step import TrainState, make_train_step

device = C.init_distributed("cuda", sys.argv[1])
world, rank = C.num_processes(), C.process_index()
t = torch.full((3,), float(rank + 1), device=device)
assert float(C.all_reduce_sum(t)[0]) == world * (world + 1) / 2
part = C.reduce_scatter(torch.empty(2, device=device),
                        torch.ones(2 * world, device=device))
assert (part == world).all()
bf16 = torch.bfloat16
full = C.all_gather(torch.empty(2 * world, device=device, dtype=bf16),
                    torch.full((2,), rank, device=device, dtype=bf16))
assert full.tolist() == [float(r) for r in range(world) for _ in range(2)]
assert C.all_gather_list(rank) == list(range(world))
torch.backends.cuda.matmul.allow_tf32 = False
cfg = resolve_kernel_policies(tiny_config(hidden_dropout_prob=0.0,
                                          attention_probs_dropout_prob=0.0),
                              "cuda", training=True)
rng = np.random.RandomState(0)
b, s = 8, 12
batch = dict(input_ids=rng.randint(1, 500, (b, 8)),
             position_ids=np.tile(np.arange(8), (b, 1)),
             img_feat=rng.randn(b, 4, 32).astype(np.float32),
             img_pos_feat=rng.rand(b, 4, 7).astype(np.float32),
             attn_mask=np.ones((b, s), np.int32),
             targets=rng.rand(b, 5).astype(np.float32),
             ex_weight=np.array([1] * 6 + [0] * 2, np.float32))
n = b // world
mine = {k: torch.from_numpy(v[rank * n:(rank + 1) * n]).to(device)
        for k, v in batch.items()}
out = {}
for fsdp in (False, True):
    torch.manual_seed(0)
    model = UniterForVisualQuestionAnswering(cfg, img_dim=32,
                                             num_answer=5).to(device)
    state = TrainState(step=0, model=model, opt=build_optimizer(
        model, 1e-3, grad_norm=1e-3, fused=True, fsdp=fsdp,
        fsdp_min_size=64))
    step = make_train_step(lambda m, bt, g: (vqa_loss(m, bt, g, 5), {}))
    losses = [float(step(state, mine, 0)[1]["loss"]) for _ in range(2)]
    out[fsdp] = (losses, torch.cat([p.detach().reshape(-1).float().cpu()
                                    for p in model.parameters()]))
if rank == 0:
    torch.save(out, sys.argv[2])
"""


def _dist_run(tmp_path, world, backend):
    import os
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / f"{backend}{world}.pt")
    procs = [subprocess.Popen(
        [sys.executable, "-c", DIST_CODE, backend, out], cwd=root,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                 LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    for p in procs:
        log = p.communicate(timeout=600)[0]
        assert p.returncode == 0, log[-3000:]
    return torch.load(out)


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_process_group_on_the_card(gen, tmp_path, world, backend):
    """The collectives on CUDA tensors (NCCL at world 1; gloo with two
    ranks sharing the card), and two train steps of a small VQA model
    through K1-K6 (dropout 0, the clip active at every step), replicated
    and with --fsdp: the same losses and parameters (1e-6) as one process
    without a process group."""
    if backend == "nccl" and world > torch.cuda.device_count():
        pytest.skip("NCCL takes one card a rank")
    got = _dist_run(tmp_path, world, backend)
    no_drop = tiny_config(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    cfg = resolve_kernel_policies(no_drop, "cuda", training=True)
    import numpy as np
    from uniter_tpu_torch.train_vqa import vqa_loss
    from uniter_tpu_torch.training.optim import build_optimizer
    from uniter_tpu_torch.training.step import TrainState, make_train_step

    rng = np.random.RandomState(0)
    b = 8
    batch = dict(input_ids=rng.randint(1, 500, (b, 8)),
                 position_ids=np.tile(np.arange(8), (b, 1)),
                 img_feat=rng.randn(b, 4, 32).astype(np.float32),
                 img_pos_feat=rng.rand(b, 4, 7).astype(np.float32),
                 attn_mask=np.ones((b, 12), np.int32),
                 targets=rng.rand(b, 5).astype(np.float32),
                 ex_weight=np.array([1] * 6 + [0] * 2, np.float32))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    torch.manual_seed(0)
    model = UniterForVisualQuestionAnswering(cfg, img_dim=32,
                                             num_answer=5).cuda()
    state = TrainState(step=0, model=model, opt=build_optimizer(
        model, 1e-3, grad_norm=1e-3, fused=True))
    step = make_train_step(lambda m, bt, g: (vqa_loss(m, bt, g, 5), {}))
    losses = [float(step(state, batch, 0)[1]["loss"]) for _ in range(2)]
    params = torch.cat([p.detach().reshape(-1).float().cpu()
                        for p in model.parameters()])
    for fsdp, (got_l, got_p) in got.items():
        assert len(got_l) == len(losses), fsdp
        for i, (x, want) in enumerate(zip(got_l, losses)):
            assert abs(x - want) <= 1e-6 * abs(want), (fsdp, i, x, want)
        assert torch.allclose(got_p, params, atol=1e-6, rtol=0), fsdp


def test_backward_is_the_same_every_run(gen):
    """Three forward + backward passes of a small VQA model through K1-K6
    on the same batch and seeds give bit-equal gradients, the token-type
    table's too (its rows take thousands of ids each, which CUDA's
    embedding backward sums in a changing order; the port reads tables
    of at most ``ONE_HOT_ROWS`` rows as a one-hot product)."""
    from uniter_tpu_torch.train_vqa import vqa_loss
    from uniter_tpu_torch.training.step import step_generator

    cfg = resolve_kernel_policies(
        tiny_config(dtype="bfloat16", hidden_dropout_prob=0.1,
                    attention_probs_dropout_prob=0.1), "cuda",
        training=True)
    b, t, r = 96, 64, 40
    batch = {"input_ids": torch.randint(1, 500, (b, t), generator=gen,
                                        device="cuda"),
             "position_ids": torch.arange(t, device="cuda").expand(b, t),
             "img_feat": torch.randn(b, r, 32, generator=gen, device="cuda"),
             "img_pos_feat": torch.rand(b, r, 7, generator=gen,
                                        device="cuda"),
             "attn_mask": torch.ones(b, t + r, dtype=torch.int32,
                                     device="cuda"),
             "targets": torch.rand(b, 9, generator=gen, device="cuda"),
             "ex_weight": torch.ones(b, device="cuda")}
    grads = []
    for _ in range(3):
        torch.manual_seed(0)
        model = UniterForVisualQuestionAnswering(cfg, img_dim=32,
                                                 num_answer=9).cuda().train()
        vqa_loss(model, batch, step_generator(0, 0), 9).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert "uniter.embeddings.token_type_embeddings.weight" in grads[0]
    for other in grads[1:]:
        for n, g in grads[0].items():
            assert torch.equal(g, other[n]), n
