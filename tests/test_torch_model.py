"""The port's trunk, VQA head and weight bridge against the JAX package, on
the CPU in fp32 with dropout off.

One JAX parameter tree (flax init, then perturbed with numpy so LayerNorm
weights and biases are not ones and zeros) feeds both packages through
``state_dict_from_jax_params``. Tolerances: max |diff| <= 1e-4 at
``tiny_config`` and <= 1e-3 at base width (768 hidden, 12 heads, 3072
FFN, 28996-word vocabulary, 3129 answers; depth cut to 2 layers), the
fp32 rounding of another summation order through the layers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uniter_tpu.config import base_config as jax_base, tiny_config as jax_tiny
from uniter_tpu.models.checkpoint import (
    export_state_dict, load_torch_checkpoint as jax_load_pt)
from uniter_tpu.models.encoder import UniterModel as JaxUniterModel
from uniter_tpu.models.vqa import (
    UniterForVisualQuestionAnswering as JaxVqa)
from uniter_tpu.utils.save import save_params_msgpack
from uniter_tpu_torch import config as pconfig
from uniter_tpu_torch.models.checkpoint import (
    load_torch_checkpoint, state_dict_from_jax_params)
from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
from uniter_tpu_torch.utils.save import load_params_msgpack

torch.set_num_threads(2)

IMG_DIM = 32
N_ANS = 11


def _batch(b, t, r, img_dim, vocab, seed=0):
    rng = np.random.RandomState(seed)
    attn = np.ones((b, t + r), np.int32)
    attn[0, t - 3:t] = 0
    attn[1 % b, t + r - 2:] = 0
    return dict(
        input_ids=rng.randint(1, vocab, (b, t)).astype(np.int32),
        position_ids=np.broadcast_to(np.arange(t, dtype=np.int32),
                                     (b, t)).copy(),
        img_feat=rng.randn(b, r, img_dim).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=attn,
    )


def _jax_params(cfg, batch, num_answer, img_dim, seed=0):
    model = JaxVqa(cfg, img_dim=img_dim, num_answer=num_answer)
    params = model.init({"params": jax.random.PRNGKey(seed)},
                        {k: jnp.asarray(v) for k, v in batch.items()},
                        False)["params"]
    rng = np.random.RandomState(seed + 1)
    return jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, x.shape)).astype(
            np.float32), jax.tree.map(np.asarray, dict(params)))


def _port(cfg_kw, params, num_answer, img_dim):
    model = UniterForVisualQuestionAnswering(
        pconfig.UniterConfig(**cfg_kw), img_dim=img_dim,
        num_answer=num_answer)
    sd = state_dict_from_jax_params(params)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                          strict=True)
    return model.eval()


def _tiny_kw(**kw):
    return pconfig.tiny_config(**kw).to_dict()


@pytest.fixture(scope="module")
def tiny():
    kw = _tiny_kw()
    batch = _batch(4, 8, 6, IMG_DIM, kw["vocab_size"])
    params = _jax_params(jax_tiny(), batch, N_ANS, IMG_DIM)
    return kw, batch, params, _port(kw, params, N_ANS, IMG_DIM)


def _tt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_state_dict_matches_export_state_dict(tiny):
    _, _, params, _ = tiny
    ours = state_dict_from_jax_params(params)
    theirs = export_state_dict(params)
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert np.array_equal(ours[k], v), k


@pytest.mark.parametrize("chunk", [None, 4096])
def test_msgpack_snapshot_round_trip(tiny, tmp_path, monkeypatch, chunk):
    """A flax ``to_bytes`` snapshot reads back exactly; ``chunk`` forces
    flax's chunked-array form for arrays above that many bytes."""
    import flax.serialization

    if chunk:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
    _, _, params, _ = tiny
    path = str(tmp_path / "model_step_1.msgpack")
    save_params_msgpack(path, params)
    back = load_params_msgpack(path)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat] == [p for p, _ in got]
    for (p, a), (_, b) in zip(flat, got):
        assert a.dtype == b.dtype and np.array_equal(a, b), p


def test_torch_checkpoint_normalizes_like_jax(tiny, tmp_path):
    """A reference-style .pt (gamma/beta names, fp16 values, ``uniter.``
    prefix) normalizes exactly as the JAX package normalizes it, and its
    trunk loads into the port strictly."""
    kw, _, params, _ = tiny
    sd = {}
    for i, (k, v) in enumerate(export_state_dict(params).items()):
        k = k.replace("LayerNorm.weight", "LayerNorm.gamma")
        sd[k] = torch.tensor(v.astype(np.float16) if i % 3 == 0 else v)
    path = str(tmp_path / "ref.pt")
    torch.save(sd, path)
    ours, theirs = load_torch_checkpoint(path), jax_load_pt(path)
    assert list(ours) == list(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        assert np.array_equal(ours[k], theirs[k]), k
    trunk = {k: torch.tensor(v) for k, v in ours.items()
             if not k.startswith("vqa_output.")}
    fresh = _port(kw, params, N_ANS, IMG_DIM)  # the fixture's stays exact
    fresh.uniter.load_state_dict(trunk, strict=True)


def _jax_trunk(cfg, params, batch, **kw):
    seq, pooled = JaxUniterModel(cfg, IMG_DIM).apply(
        {"params": params["uniter"]},
        *(None if batch.get(k) is None else jnp.asarray(batch[k])
          for k in ("input_ids", "position_ids", "img_feat", "img_pos_feat",
                    "attn_mask")),
        method=JaxUniterModel.init_all, **kw)
    return np.asarray(seq), np.asarray(pooled)


@pytest.mark.parametrize("mode", ["joint", "joint_img_masks", "text_only",
                                  "image_only"])
def test_trunk_matches_jax_tiny(tiny, mode):
    """Hidden states and pooled output in the three input modes (and with
    MRM img_masks), max |diff| <= 1e-4."""
    _, batch, params, model = tiny
    batch = dict(batch)
    kw = {}
    t = batch["input_ids"].shape[1]
    if mode == "joint_img_masks":
        kw["img_masks"] = (np.random.RandomState(3).rand(4, 6) < 0.4)
    elif mode == "text_only":
        batch.update(img_feat=None, img_pos_feat=None,
                     attn_mask=batch["attn_mask"][:, :t])
    elif mode == "image_only":
        batch.update(input_ids=None, position_ids=None,
                     attn_mask=batch["attn_mask"][:, t:])
    seq_j, pooled_j = _jax_trunk(
        jax_tiny(), params, batch,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    tb = {k: None if v is None else torch.from_numpy(np.asarray(v))
          for k, v in batch.items()}
    with torch.no_grad():
        seq = model.uniter(**tb, **{k: torch.from_numpy(v)
                                    for k, v in kw.items()})
        pooled = model.uniter.pooler(seq)
    assert np.abs(seq.numpy() - seq_j).max() <= 1e-4
    assert np.abs(pooled.numpy() - pooled_j).max() <= 1e-4


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_vqa_logits_match_jax_tiny(tiny, fused_qkv):
    kw, batch, params, _ = tiny
    model = _port(dict(kw, fused_qkv=fused_qkv), params, N_ANS, IMG_DIM)
    jmodel = JaxVqa(jax_tiny(fused_qkv=fused_qkv), img_dim=IMG_DIM,
                    num_answer=N_ANS)
    ref = np.asarray(jmodel.apply(
        {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
        False))
    with torch.no_grad():
        out = model.predict(_tt(batch))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() <= 1e-4


def test_ids_out_of_range_clip_like_jax(tiny):
    """Word, position and type ids past either end of their tables are
    clamped, as the JAX package's ``jnp.take(mode="clip")`` clamps them."""
    kw, batch, params, model = tiny
    batch = dict(batch)
    ids = batch["input_ids"].copy()
    ids[0, 1], ids[1, 2], ids[2, 3] = -7, kw["vocab_size"], 10 ** 6
    pos = batch["position_ids"].copy()
    pos[3, :] = kw["max_position_embeddings"] + 5
    batch.update(input_ids=ids, position_ids=pos,
                 txt_type_ids=np.full_like(ids, 9))
    ref = np.asarray(JaxVqa(jax_tiny(), img_dim=IMG_DIM, num_answer=N_ANS)
                     .apply({"params": params},
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            False))
    with torch.no_grad():
        out = model.predict(_tt(batch)).numpy()
    assert np.abs(out - ref).max() <= 1e-4


def test_vqa_logits_match_jax_base_width():
    """uniter-base widths, depth cut to 2 layers, B=2, T=16, R=8."""
    kw = pconfig.base_config(num_hidden_layers=2, dtype="float32").to_dict()
    batch = _batch(2, 16, 8, 2048, kw["vocab_size"], seed=5)
    params = _jax_params(jax_base(num_hidden_layers=2, dtype="float32"),
                         batch, 3129, 2048, seed=5)
    model = _port(kw, params, 3129, 2048)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = np.asarray(JaxVqa(jax_base(num_hidden_layers=2, dtype="float32"),
                            img_dim=2048, num_answer=3129)
                     .apply({"params": params}, jb, False))
    seq_j = np.asarray(JaxUniterModel(
        jax_base(num_hidden_layers=2, dtype="float32"), 2048).apply(
        {"params": params["uniter"]}, jb["input_ids"], jb["position_ids"],
        jb["img_feat"], jb["img_pos_feat"], jb["attn_mask"]))
    with torch.no_grad():
        tb = _tt(batch)
        out = model.predict(tb).numpy()
        seq = model.uniter(**tb).numpy()
    assert np.abs(seq - seq_j).max() <= 1e-3
    assert np.abs(out - ref).max() <= 1e-3


def test_live_dropout_waits_for_training_slice(tiny):
    """Live dropout draws its seeds from an explicit generator (there is no
    silent use of torch's global one); the same generator seed gives the
    same logits, another seed other logits."""
    _, batch, _, model = tiny
    with pytest.raises(ValueError):
        model.predict(_tt(batch), deterministic=False)

    def live(seed):
        with torch.no_grad():
            return model.predict(_tt(batch), deterministic=False,
                                 generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(live(1), live(1), atol=0, rtol=0)
    assert not torch.equal(live(1), live(2))
    with torch.no_grad():
        assert not torch.equal(live(1), model.predict(_tt(batch)))


@pytest.mark.parametrize("impl,device,want", [
    ("auto", "cpu", "xla"), ("pallas", "cpu", "xla"), ("xla", "cuda", "xla"),
    ("auto", "cuda", "cuda"), ("pallas", "cuda", "cuda"),
    ("pallas_nt", "cuda:0", "cuda"),
])
def test_resolve_kernel_policies_from_explicit_device(impl, device, want):
    cfg = pconfig.UniterConfig.from_dict(
        dict(jax_tiny(attention_impl=impl, block_fusion="pallas").to_dict()))
    got = pconfig.resolve_kernel_policies(cfg, device)
    assert got.attention_impl == want
    with pytest.raises(ValueError):
        pconfig.resolve_kernel_policies(cfg.replace(attention_impl="x"),
                                        device)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_resolve_kernel_policies_for_training(device):
    """Training: block fusion "auto" and "pallas" select the fused tail
    kernels K3-K6 ("cuda") on the card and the plain tails ("none") on the
    CPU; "none" stays "none" everywhere; inference never fuses; the 16/8-bit
    dropout thresholds pass through on every device and an unknown rule
    raises."""
    cfg = pconfig.UniterConfig.from_dict(dict(jax_tiny().to_dict()))
    for bf in ("auto", "pallas", "cuda"):
        got = pconfig.resolve_kernel_policies(
            cfg.replace(block_fusion=bf), device, training=True)
        assert got.block_fusion == ("cuda" if device == "cuda" else "none")
        assert pconfig.resolve_kernel_policies(
            cfg.replace(block_fusion=bf), device).block_fusion == "none"
    assert pconfig.resolve_kernel_policies(
        cfg.replace(block_fusion="none"), device,
        training=True).block_fusion == "none"
    with pytest.raises(ValueError):
        pconfig.resolve_kernel_policies(cfg.replace(block_fusion="x"), device,
                                        training=True)
    for impl in ("u16", "u8"):
        assert pconfig.resolve_kernel_policies(
            cfg.replace(dropout_impl=impl), device,
            training=True).dropout_impl == impl
    with pytest.raises(ValueError, match="u4"):
        pconfig.resolve_kernel_policies(cfg.replace(dropout_impl="u4"),
                                        device, training=True)
    assert pconfig.resolve_kernel_policies(
        cfg.replace(dropout_impl="u16"), device).dropout_impl == "u16"
