"""The ``answer_vqa`` cell at a tiny size on the CPU through the harness:
a tiny BEiT-3 configuration and mix added to a checkout as files and
entries alone. A sound run is ``correct``; ``half_batch`` fails
``logit_gap``; the control reads a wider gap than the program; the
traced run's ``split_mb_per_pair.vqa`` is the hand count of the split and
merge copies (``tests/test_torch_beit3.py``), ``mfu.vqa`` and
``fused_tail_share.score`` read. The check's reference inputs do not come
from the port's collate; the float32 scoring cell's readers count their
peaks."""

from __future__ import annotations

import json
import os

import pytest

from gpubench.tests.conftest import make_checkout, run_cell

TINY = {"encoder_embed_dim": 64, "encoder_attention_heads": 4,
        "encoder_ffn_embed_dim": 256, "encoder_layers": 2, "img_size": 64,
        "vocab_size": 101}


@pytest.fixture(scope="module")
def beit3_checkout(tmp_path_factory):
    dest = make_checkout(str(tmp_path_factory.mktemp("beit3")))
    g = os.path.join(dest, "gpubench")
    with open(os.path.join(g, "configs", "beit3-large.json")) as f:
        cfg = {**json.load(f), **TINY, "dtype": "float32",
               "reduced": sorted(TINY)}
    with open(os.path.join(g, "configs", "beit3-tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(g, "mixes", "vqa-serve-480.json")) as f:
        mix = json.load(f)
    mix["corpus"].update(n_img=12, n_txt=60)
    mix["recipe"].update(dtype="float32", pairs_per_call=16, num_answer=20)
    with open(os.path.join(g, "mixes", "tiny-vqa-serve.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(dest, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "beit3-tiny", "source": "tests", "reduced": sorted(TINY),
        "file": "gpubench/configs/beit3-tiny.json", "why": "CPU tests"})
    bench["workloads"].append({"name": "tiny-beit3", "config": "beit3-tiny",
                               "traffic": "tiny-vqa-serve", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "beit3-large-vqa-serve" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + ["tiny-beit3"]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


def test_sound_traced_run(beit3_checkout, capsys):
    code, out = run_cell(beit3_checkout, "tiny-beit3", trace=1,
                         capsys=capsys)
    assert code == 0 and out["correct"], out
    m = out["metrics"]
    # (8 L + 1) B S H x 4 bytes a call over its B pairs: S = 17 + T, T
    # the call's longest question rounded up to 8 (the profiled calls'
    # lengths are the mix's)
    assert any(m["split_mb_per_pair.vqa"]["value"] == pytest.approx(
        (8 * 2 + 1) * (17 + t) * 64 * 4 / 1e6) for t in (8, 16, 24))
    assert m["mfu.vqa"]["value"] > 0
    assert "fused_tail_share.score" in m


def test_half_batch_fails(beit3_checkout, capsys):
    code, out = run_cell(beit3_checkout, "tiny-beit3", "--fault",
                         "half_batch", capsys=capsys)
    assert code == 0 and not out["correct"], out


def test_control_reads_wider(beit3_checkout, capsys):
    from gpubench import run

    code = run.main(["--workload", "tiny-beit3", "--mode", "control",
                     "--seeds", "11,4000000007"], require_card=False,
                    device="cpu", root=beit3_checkout)
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines() if x.startswith("{")]
    assert code == 0 and len(lines) == 2
    for x in lines:
        assert x["control"]["logit_gap"] > 100 * x["program"]["logit_gap"]


def test_check_pads_text_without_the_collate():
    """The reference's ids and key mask are padded from the records in the
    driver, and equal the port's collate at the call's width."""
    import numpy as np

    from gpubench.drivers.answer_vqa import PAD, pad_text
    from uniter_tpu_torch.data.pixel_db import collate_beit3

    recs = [{"input_ids": np.arange(n) + 3, "img": f"i{n % 2}", "qid": n}
            for n in (3, 9, 5)]
    ids, mask = pad_text(recs, 24)
    b = collate_beit3(recs, lambda name: np.zeros((3, 2, 2), np.uint8), PAD,
                      multiple=24)
    assert (ids == b["input_ids"]).all() and (mask == b["text_mask"]).all()
    assert ids.shape == (3, 24) and mask.sum() == 17


def test_fp32_readers_count_their_peaks(beit3_checkout):
    """``mfu.fp32`` at 67 TFLOP/s; ``attn_roofline.fp32`` at 495/3
    TFLOP/s against 4-byte elements; both None without work or a trace."""
    import types

    from gpubench.harness import Benchmark

    bench = Benchmark(beit3_checkout)
    work = {"flop": 67e12, "k1_flop": 495e12 / 3, "k1_bytes": 1e6}
    run = types.SimpleNamespace(
        window_s=2.0, work=[work], prof_work=[work],
        profile={"kernels": {"mha_fwd_tf32_kernel<64>": (4.0, 1),
                             "tail_fwd": (1.0, 1)}})
    assert bench.reader("mfu.fp32")(run) == pytest.approx(50.0)
    assert bench.reader("attn_roofline.fp32")(run) == pytest.approx(25.0)
    run.work[0]["k1_bytes"] = 3.35e12 * 8 / 2  # 8 s over HBM at 4 bytes
    assert bench.reader("attn_roofline.fp32")(run) == pytest.approx(200.0)
    empty = types.SimpleNamespace(window_s=1.0, work=[], prof_work=[],
                                  profile=None)
    for name in ("mfu.fp32", "attn_roofline.fp32"):
        assert bench.reader(name)(empty) is None
