"""The yardstick's counts against counts worked by hand at small shapes,
valid lengths included, and the per-layer readers on made-up records."""

from __future__ import annotations

import types

import numpy as np
import pytest

from gpubench import yardstick as ys
from gpubench.harness import Benchmark, leaf_gap

CFG = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2,
       "vocab_size": 10, "img_label_dim": 5}


def _batch(t_b=3, r_b=2):
    """Two rows: (2 words, 1 region) and (3 words, 2 regions)."""
    mask = np.array([[1, 1, 0, 1, 0], [1, 1, 1, 1, 1]], np.int32)
    return {"input_ids": np.zeros((2, t_b), np.int32), "attn_mask": mask,
            "ex_weight": np.ones(2, np.float32)}


def test_lengths_count_valid_positions_only():
    t, r = ys.lengths(_batch())
    assert t.tolist() == [2, 3] and r.tolist() == [1, 2]


def test_trunk_flops_by_hand():
    # row n=3: per layer 3 (8*16 + 4*4*8) + 4*9*4 = 912; n=5: 5*256 + 400
    # = 1680; two layers; regions 1 + 2 through 2 (2048 + 7) 4
    want = 2 * (912 + 1680) + 3 * 2 * 2055 * 4
    assert ys.trunk_flops([2, 3], [1, 2], CFG) == want


def test_head_flops_by_hand():
    b = _batch()
    assert ys.head_flops("vqa", b, CFG, num_answer=3) == \
        2 * (2 * 16 + 2 * (2 * 16 + 2 * 4 * 3))
    b["mlm_tgt"] = np.array([[5, -1], [-1, -1]])
    assert ys.head_flops("mlm", b, CFG) == 1 * 2 * (16 + 4 * 10)
    b["mrm_valid"] = np.array([[1.0, 0.0], [1.0, 1.0]])
    assert ys.head_flops("mrfr", b, CFG) == 3 * 2 * (16 + 4 * 2048)
    assert ys.head_flops("mrckl", b, CFG) == 3 * 2 * (16 + 4 * 5)
    assert ys.head_flops("itm", b, CFG) == \
        2 * (2 * 16 + 2 * 2 * 4) + 2 * (2 * 1 + 3 * 2) * 4


def test_attention_and_tails_by_hand():
    w = ys.attention_work([2, 3], [1, 2], CFG)
    assert w["k1_flop"] == 2 * 4 * 4 * (9 + 25)
    assert w["k1_bytes"] == 2 * (4 * 8 * 4 * 2 + 4 * 8)
    assert w["k2_flop"] == 2 * 10 * 4 * 34
    assert w["k2_bytes"] == 2 * (7 * 8 * 4 * 2 + 4 * 8)
    tails = ys.tail_work([2, 3], [1, 2], CFG)
    k3 = 4 * (3 * 8 * 4 * 2 + 2 * 4 * 4)
    k4 = 4 * (5 * 8 * 4 * 2 + 3 * 4 * 4)
    k5 = (2 * 5 * 4 * 2 + 2 * 16) + (2 * 3 * 4 * 2 + 2 * 16)
    k6 = (3 * 5 * 4 * 2 + 3 * 16) + (3 * 3 * 4 * 2 + 3 * 16)
    assert tails["tails_bytes"] == k3 + k4 + k5 + k6
    assert tails["tails_ops"] == 4 * 8 * 4 * (8 + 16) + (5 + 3) * 4 * (7 + 13)


def test_ipot_and_bound_by_hand():
    w = ys.ipot_work([2, 3], [1, 2])
    assert w["ot_ops"] == 50 * 7 * (2 + 6)
    assert w["ot_bytes"] == 4 * ((2 * 2 + 4 + 1 + 2) + (2 * 6 + 6 + 2 + 2))
    assert ys.bound_s(989e12, 0, ys.PEAK_BF16) == pytest.approx(1.0)
    assert ys.bound_s(0, 3.35e12, ys.PEAK_BF16) == pytest.approx(1.0)


def test_train_batch_work_counts_backward_twice():
    b = _batch()
    w = ys.train_batch_work("vqa", b, CFG, num_answer=3)
    fwd = ys.trunk_flops([2, 3], [1, 2], CFG) + ys.head_flops("vqa", b, CFG, 3)
    assert w["flop"] == 3 * fwd
    assert (w["ex"], w["valid"], w["slots"]) == (2, 8, 10)


def test_readers_on_a_made_up_record():
    bench = Benchmark()
    work = [{"ex": 2, "valid": 8, "slots": 10, "flop": 989e12 * 0.5,
             "feed_s": 0.01, "k1_flop": 0, "k1_bytes": 3.35e12 * 0.25,
             "k2_flop": 0, "k2_bytes": 3.35e12 * 0.25, "tails_ops": 0,
             "tails_bytes": 3.35e12 * 0.1}]
    prof = {"busy_s": 0.75, "wall_s": 1.0, "steps": 1, "ops_per_step": 7,
            "kernels": {"mha_fwd_tc_kernel<64>": (0.5, 1),
                        "mha_bwd_tc_kernel<64>": (0.5, 1),
                        "tail_fwd<bf16>": (0.2, 2)}}
    run = types.SimpleNamespace(work=work, prof_work=work, window_s=1.0,
                                profile=prof)
    want = {"mfu.train": 50.0, "pad_share.train": 20.0,
            "feed_ms_per_batch.train": 10.0, "attn_roofline.train": 50.0,
            "tails_roofline.train": 50.0, "device_idle_share.train": 25.0,
            "device_ops_per_step.train": 7}
    for name, v in want.items():
        assert bench.reader(name)(run) == pytest.approx(v)
    assert bench.reader("ot_roofline.train")(run) is None


def test_leaf_gap_uses_the_median_floor():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    worst, at = leaf_gap({"a": 1.1, "b": 2.0, "c": 0.5}, ref)
    assert at == "c" and worst == pytest.approx(0.5 / 1.0)
