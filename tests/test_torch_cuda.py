"""The port's CUDA kernels on the card (marker ``cuda``; they skip without a
CUDA device). The file imports torch and the port only, so it runs on a
machine without jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures jax for the CPU suite.)

K1 (``csrc/mha_fwd.cu``) is held against its plain version at the main
path's attention shape, fp32 to 1e-5 and bf16 (against fp32 on the same
bf16 inputs) to 1e-2; rows whose keys are all padding as
tests/test_torch_attention.py explains. A small VQA model answers the same
through the kernel and through the plain attention.
"""

import pytest
import torch

from uniter_tpu_torch.config import resolve_kernel_policies, tiny_config
from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
from uniter_tpu_torch.ops.attention import _mha_torch, mha_fwd

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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,s", [(96, 104), (8, 512), (3, 13)])
def test_mha_kernel_matches_plain(gen, dtype, tol, b, s):
    q, k, v, bias = _inputs(gen, b, s, 12, 64, dtype)
    before = mha_fwd.launches
    out = mha_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert mha_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    diff = (out.float() - _mha_torch(q.float(), k.float(), v.float(),
                                     bias)).abs()
    assert torch.cat([diff[:1], diff[2:]]).max().item() <= tol
    assert diff[1].max().item() <= 2.0**-9 * v[1].float().abs().max() + tol
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
