"""BEiT-3 VQA in the port (``uniter_tpu_torch/models/beit3.py``) on the CPU,
at a tiny size (2 layers, width 64, 4 heads, FFN 256, 64-px images of 16-px
patches, a 101-word vocabulary), on seeded weights whose LayerNorms differ
between the two experts (``gpubench/reference/beit3.py`` ``init_params``):

* the port's logits against the plain reference within 1e-5 in fp32 (the
  two differ only in the fp32 order of sums: the port splits rows by
  segment and merges them, the reference runs both experts over the whole
  sequence), with and without the encoder's output norm; the same port in
  bf16 (about 4e-3 of rounding) and a port with its experts swapped miss it;
* images shared through ``img_index`` give the logits of one image a pair;
* the counters (``multiway.split_bytes``, ``multiway.rows.*``, ``tail.*``)
  against a hand count, and ``infer.batch`` as the serving loop's root span;
* K1's new sequence limit (the forward up to 1,024, K2 up to 512) and the
  multiway tail's refusals;
* the pixel store (``data/pixel_db.py``) and ``inf_vqa.main`` on a BEiT-3
  run directory from disk against the model's own logits; training
  refuses.
"""

from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpubench.reference.beit3 import (Forward, RefBeit3Config, RefBeit3Vqa,
                                      init_params)
from uniter_tpu_torch.models.beit3 import (Beit3Config,
                                           Beit3ForVisualQuestionAnswering)
from uniter_tpu_torch.ops import attention, fused_block
from uniter_tpu_torch.utils import trace

torch.set_num_threads(2)

TINY = dict(encoder_embed_dim=64, encoder_attention_heads=4,
            encoder_ffn_embed_dim=256, encoder_layers=2, vocab_size=101,
            img_size=64, patch_size=16)
N_ANSWER = 10
SEED = 20221001


def _models(normalize_output=True, dtype="float32"):
    cfg = Beit3Config(**TINY, normalize_output=normalize_output, dtype=dtype)
    port = Beit3ForVisualQuestionAnswering(cfg, N_ANSWER).eval()
    ref = RefBeit3Vqa(RefBeit3Config.from_dict(
        TINY, normalize_output=normalize_output), N_ANSWER)
    sd = init_params(ref, SEED, "cpu")
    ref.load_state_dict(sd)
    port.load_state_dict(sd)
    return port, ref, sd


def _batch(n_pairs=5, n_img=3, t=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    px = torch.randint(0, 256, (n_img, 3, 64, 64), dtype=torch.uint8,
                       generator=g)
    idx = torch.arange(n_pairs) % n_img
    lens = torch.tensor([t, 6, 3, t - 1, 5][:n_pairs])
    mask = (torch.arange(t)[None, :] < lens[:, None]).long()
    ids = torch.randint(3, 101, (n_pairs, t), generator=g)
    ids[:, 0] = 0
    ids[torch.arange(n_pairs), lens - 1] = 2
    ids[mask == 0] = 1
    return {"pixel_values": px, "img_index": idx, "input_ids": ids,
            "text_mask": mask}


def _swapped(sd):
    """The state dict with every expert pair's A and B exchanged (the
    position tables, of two sizes, stay)."""
    out = dict(sd)
    for k, v in sd.items():
        twin = k.replace(".A.", ".B.") if ".A." in k else k.replace(".B.",
                                                                    ".A.")
        if twin != k and sd[twin].shape == v.shape:
            out[k] = sd[twin]
    return out


@pytest.mark.parametrize("normalize_output", [True, False])
@pytest.mark.parametrize("case,within", [("float32", True),
                                         ("bfloat16", False),
                                         ("swapped", False)])
def test_logits_against_reference(case, within, normalize_output):
    """fp32 within 1e-5 of the reference; bf16 and swapped experts not."""
    port, ref, sd = _models(normalize_output,
                            "bfloat16" if case == "bfloat16" else "float32")
    if case == "swapped":
        port.load_state_dict(_swapped(sd))
    b = _batch()
    with torch.inference_mode():
        got = port.predict(b)
        want = Forward(ref).logits(b["pixel_values"][b["img_index"]],
                                   b["input_ids"], b["text_mask"])
    gap = (got - want).abs().max().item()
    assert got.dtype == torch.float32 and got.shape == (5, N_ANSWER)
    assert (gap <= 1e-5) == within, gap
    assert want.std().item() > 0.05  # the logits spread: a gap means it


def test_shared_images_equal_per_pair_images():
    port, _, _ = _models()
    b = _batch(n_pairs=5, n_img=2)
    per_pair = dict(b, pixel_values=b["pixel_values"][b["img_index"]],
                    img_index=torch.arange(5))
    with torch.inference_mode():
        assert torch.equal(port.predict(b), port.predict(per_pair))


def test_counters_against_hand_count():
    """Per forward at B pairs of S = split + T positions, fp32: each layer
    splits its LN1 output, the inner LN's and LN2's (3 B S H elements,
    each copied) and merges Q/K/V (3H wide), the output projection and
    FC2 (5 B S H), and the embedding merges its two segments (B S H):
    (8 L + 1) B S H x 4 bytes. Rows through each expert's GEMMs: 4 a
    layer (QKV, out, FC1, FC2). On the CPU every tail is plain."""
    port, _, _ = _models(normalize_output=True)
    b = _batch()
    cfg = port.config
    n, t, h, layers = 5, 8, 64, 2
    s = cfg.split + t
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]):
        port.predict(b)
        snap = trace.snapshot()
    assert snap["counts"] == {
        "multiway.split_bytes": (8 * layers + 1) * n * s * h * 4,
        "multiway.rows.vision": 4 * layers * n * cfg.split,
        "multiway.rows.text": 4 * layers * n * t,
        # the embedding's LN1, per layer LNin, LN2 and LNffn, the next
        # layer's LN1 (once), the output norm, the pooler's, the head's
        "tail.plain": 1 + 3 * layers + 1 + 1 + 1 + 1}
    assert {"beit3.embed", "beit3.encoder", "beit3.head"} <= set(
        snap["totals"])


def test_serving_loop_root_span():
    from uniter_tpu_torch.inf_vqa import answer_questions

    port, _, _ = _models()
    b = {k: v.numpy() for k, v in _batch().items()}
    b["qids"] = [f"q{i}" for i in range(5)]
    with profile(activities=[ProfilerActivity.CPU]):
        res, logits = answer_questions(port, [b, b], {i: str(i) for i in
                                                      range(N_ANSWER)},
                                       "cpu", keep_logits=True)
        snap = trace.snapshot()
    roots = [sp for sp in snap["spans"] if sp["name"] == "infer.batch"]
    assert [sp["request"] for sp in roots] == [0, 1]
    assert all(sp["parent"] is None for sp in roots)
    assert len(res) == 10 and set(logits) == set(b["qids"])


@pytest.mark.parametrize("s", [513, 925, 1024])
def test_k1_forward_takes_past_512_and_k2_refuses(s):
    attention._check_seq(s, "mha_fwd")
    with pytest.raises(ValueError, match="backward kernel"):
        attention._check_seq(s, "mha_bwd")


@pytest.mark.parametrize("call", ["fwd_1025", "bwd_513", "function_513"])
def test_k1_sequence_refusals(call):
    s = {"fwd_1025": 1025, "bwd_513": 513, "function_513": 513}[call]
    q = torch.zeros(1, s, 1, 8)
    bias = torch.zeros(1, s)
    with pytest.raises(ValueError, match="sequence length"):
        if call == "fwd_1025":
            attention.mha_fwd(q, q, q, bias)
        elif call == "bwd_513":
            attention.mha_bwd(q, q, q, bias, q)
        else:
            attention.MhaFunction.apply(q.requires_grad_(), q, q, bias, 0.0,
                                        0)


def test_k1_plain_at_925_through_the_forward_check():
    q, k, v = (torch.randn(1, 925, 2, 8, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    bias = torch.zeros(1, 925)
    bias[0, 910:] = -10000.0
    out = attention.mha_fwd(q, k, v, bias)
    assert torch.allclose(out, attention._mha_torch(q, k, v, bias))


@pytest.mark.parametrize("bad", ["rank2", "split_past", "split_negative",
                                 "dtypes", "weight_shape"])
def test_multiway_tail_refusals(bad):
    x = torch.randn(2, 5, 8)
    res = torch.randn(2, 5, 8)
    w = [torch.randn(8) for _ in range(4)]
    split = 3
    err = ValueError
    if bad == "rank2":
        x, res = x[0], res[0]
    elif bad == "split_past":
        split = 6
    elif bad == "split_negative":
        split = -1
    elif bad == "dtypes":
        res, err = res.double(), TypeError
    else:
        w[2] = torch.randn(9)
    with pytest.raises(err):
        fused_block.multiway_tail_fwd(x, res, *w, split)


def test_multiway_tail_plain():
    """The CPU path: the sum, and each segment's LayerNorm with its own
    weights."""
    g = torch.Generator().manual_seed(1)
    x, res = (torch.randn(2, 5, 8, generator=g) for _ in range(2))
    w = [torch.randn(8, generator=g) for _ in range(4)]
    h, y = fused_block.multiway_tail_fwd(x, res, *w, 3, 1e-5)
    assert torch.equal(h, x + res)
    ln = torch.nn.functional.layer_norm
    assert torch.allclose(y[:, :3], ln(h[:, :3], (8,), w[0], w[1], 1e-5),
                          atol=1e-6)
    assert torch.allclose(y[:, 3:], ln(h[:, 3:], (8,), w[2], w[3], 1e-5),
                          atol=1e-6)
    assert torch.allclose(fused_block.multiway_tail_fwd(x, None, *w, 3,
                                                        1e-5)[:, 3:],
                          ln(x[:, 3:], (8,), w[2], w[3], 1e-5), atol=1e-6)


def test_training_refuses(tmp_path):
    from uniter_tpu_torch.training import driver

    path = tmp_path / "model.json"
    path.write_text(json.dumps({"model_type": "beit3", **TINY}))
    with pytest.raises(NotImplementedError, match="beit3"):
        driver.model_config_from_opts(types.SimpleNamespace(
            model_config=str(path), dtype="float32", device="cpu"))
    port, _, _ = _models()
    with pytest.raises(NotImplementedError):
        port(_batch())


def test_pixel_store_roundtrip_and_collate(tmp_path):
    from uniter_tpu_torch.data.pixel_db import (PixelDb, collate_beit3,
                                                write_pixel_db)

    rng = np.random.default_rng(0)
    imgs = {f"img{j}": rng.integers(0, 256, (3, 64, 64), dtype=np.uint8)
            for j in range(3)}
    db = PixelDb(write_pixel_db(str(tmp_path / "pix"), imgs.items()))
    for name, img in imgs.items():
        assert np.array_equal(db.get(name), img)
    recs = [{"input_ids": np.array([0, 5, 6, 2]), "img": "img2", "qid": "a"},
            {"input_ids": np.arange(11), "img": "img0", "qid": "b"},
            {"input_ids": np.array([0, 7, 2]), "img": "img2", "qid": "c"}]
    b = collate_beit3(recs, db.get, pad_id=1)
    assert b["input_ids"].shape == (3, 16) and b["qids"] == ["a", "b", "c"]
    assert np.array_equal(b["img_index"], [0, 1, 0])
    assert np.array_equal(b["pixel_values"][1], imgs["img0"])
    assert b["text_mask"].sum(1).tolist() == [4, 11, 3]
    assert (b["input_ids"][b["text_mask"] == 0] == 1).all()


def test_inf_vqa_beit3_from_disk(tmp_path):
    """``inf_vqa.main`` on a BEiT-3 run directory (its config's
    ``model_type`` "beit3" picks the model): a txt DB, a pixel LMDB and a
    run directory holding the config, hps and a state dict; the answers
    and logits are the model's own on the same batch."""
    from uniter_tpu_torch import inf_vqa
    from uniter_tpu_torch.data.pixel_db import write_pixel_db
    from uniter_tpu_torch.data.txt_db import write_txt_db

    port, _, sd = _models()
    rng = np.random.default_rng(1)
    imgs = {f"img{j}": rng.integers(0, 256, (3, 64, 64), dtype=np.uint8)
            for j in range(2)}
    write_pixel_db(str(tmp_path / "pix"), imgs.items())
    toks = {f"q{i}": rng.integers(3, 101, 2 + i).tolist() for i in range(5)}
    txt2img = {q: f"img{i % 2}" for i, q in enumerate(toks)}
    write_txt_db(str(tmp_path / "txt"),
                 {q: {"input_ids": t, "img_fname": txt2img[q]}
                  for q, t in toks.items()},
                 {"CLS": 0, "SEP": 2, "MASK": 3, "v_range": [3, 101]},
                 txt2img, store="lmdb")
    run = tmp_path / "run"
    os.makedirs(run / "log")
    os.makedirs(run / "ckpt")
    (run / "log" / "model.json").write_text(json.dumps(
        {"model_type": "beit3", **TINY, "dtype": "float32"}))
    (run / "log" / "hps.json").write_text(json.dumps(
        {"num_answer": N_ANSWER}))
    torch.save(sd, run / "ckpt" / "model_step_1.pt")
    opts = inf_vqa.get_parser().parse_args([
        "--txt_db", str(tmp_path / "txt"), "--img_db", str(tmp_path / "pix"),
        "--train_dir", str(run), "--output_dir", str(tmp_path / "out"),
        "--device", "cpu", "--batch_size", "3", "--save_logits"])
    out = inf_vqa.main(opts)
    with open(out) as f:
        results = json.load(f)
    logits = np.load(tmp_path / "out" / "logits.npz")
    ids = list(toks)
    assert [r["question_id"] for r in results] == ids
    for q in ids:
        n = len(toks[q]) + 2
        t = -(-n // 8) * 8
        b = {"pixel_values": torch.from_numpy(imgs[txt2img[q]][None]),
             "img_index": torch.zeros(1, dtype=torch.long),
             "input_ids": torch.ones(1, t, dtype=torch.long),
             "text_mask": torch.zeros(1, t, dtype=torch.long)}
        b["input_ids"][0, :n] = torch.tensor([0, *toks[q], 2])
        b["text_mask"][0, :n] = 1
        with torch.inference_mode():
            want = port.predict(b)[0].numpy()
        assert np.allclose(logits[q], want, atol=1e-3)  # saved as fp16
        got = {r["question_id"]: r["answer"] for r in results}[q]
        assert got == str(int(want.argmax()))
