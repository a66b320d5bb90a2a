"""The port's span and counter store (``uniter_tpu_torch/utils/trace.py``)
and its sites, on the CPU:

* with no profiler running, a span or count site records nothing and never
  enters ``record_function`` (a mock counts the entries);
* under a CPU profiler session the loops' and the scorer's spans nest
  (``optim.step`` under ``loop.step``, ``itm.tile`` under ``itm.score``),
  share their root's request id, and the main thread's spans are
  ``user_annotation`` events of the exported trace;
* ``prefetch.put`` is recorded on the prefetch thread;
* a new session starts a fresh store, and past ``CAP`` spans are counted in
  ``trace.dropped``;
* ``itm.slots`` and ``itm.valid_slots`` equal a hand count on a tiny
  corpus whose tiles repeat rows, and ``tail.plain`` counts its tails;
* threads recording at once lose no span or count.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import types
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uniter_tpu_torch.utils import trace


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _tiny_state():
    from uniter_tpu_torch.training import optim as popt
    from uniter_tpu_torch.training.step import TrainState

    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    return TrainState(step=0, model=model, opt=popt.build_optimizer(
        model, 1e-3, fused=True))


def _batches(n):
    return [{"x": np.full((2, 3), i, np.float32),
             "input_ids": np.zeros((2, 1), np.int32)} for i in range(n)]


def _loss(m, b, g):
    return m(b["x"]).square().mean(), {}


def _train_loop(kind, steps, profile_dir=None):
    from uniter_tpu_torch.train_itm_hard_negatives import HardNegLoop
    from uniter_tpu_torch.training.loop import MixedTaskLoop, TrainLoop
    from uniter_tpu_torch.training.step import make_train_step

    common = dict(state=_tiny_state(), device="cpu", num_train_steps=steps,
                  valid_steps=0, log_steps=1, preempt=False,
                  profile_dir=profile_dir)
    if kind == "train":
        return TrainLoop(loss_fn=_loss, train_loader=_batches(steps + 4),
                         **common)
    step = make_train_step(_loss)
    if kind == "hard_neg":
        return HardNegLoop(stream=iter(_batches(steps + 4)), step_fn=step,
                           mined_per_step=1, **common)
    return MixedTaskLoop(
        meta=itertools.cycle([("a_0", b) for b in _batches(3)]),
        get_step=lambda task: step, **common)


# a tiny retrieval corpus: 5 captions of 3, 5, 1, 4, 2 words (+ CLS and
# SEP), 3 images of 2, 6 and 9 regions, T = 8, R = 6
WORDS = [3, 5, 1, 4, 2]
NBB = [2, 6, 9]
T_B, R_B, IMG_DIM = 8, 6, 16


def _eval_ds(bs=None):
    rng = np.random.RandomState(0)
    feats = {f"i{j}": (rng.randn(n, IMG_DIM).astype(np.float32),
                       rng.rand(n, 7).astype(np.float32), n)
             for j, n in enumerate(NBB)}
    ds = types.SimpleNamespace(
        ids=[f"t{i}" for i in range(len(WORDS))], all_img_ids=list(feats),
        txt_db=types.SimpleNamespace(combine_inputs=lambda ids: np.concatenate(
            [[101], np.asarray(ids, np.int32), [102]])),
        img_db=types.SimpleNamespace(get_img_feat=feats.__getitem__),
        example=lambda i: {"input_ids": list(range(5, 5 + WORDS[i]))})
    if bs is not None:  # the windowed view: caption i's image is i % 3
        ds.bs = bs
        ds.txt2img = {t: f"i{i % len(NBB)}" for i, t in enumerate(ds.ids)}
        ds._img_pos = {n: j for j, n in enumerate(ds.all_img_ids)}
    return ds


@pytest.fixture(scope="module")
def scorer_model():
    from uniter_tpu_torch import config as pconfig
    from uniter_tpu_torch.models.itm import UniterForImageTextRetrieval

    torch.manual_seed(0)
    return UniterForImageTextRetrieval(pconfig.tiny_config(), img_dim=IMG_DIM)


def _by_name(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


def test_off_records_nothing_and_enters_no_record_function(scorer_model):
    from uniter_tpu_torch.utils.itm_fast import fast_score_matrix

    assert not trace.on()
    before = trace.snapshot()
    entered = mock.MagicMock()
    with mock.patch("torch.profiler.record_function", entered), \
            mock.patch("torch.autograd.profiler.record_function", entered):
        with trace.span("a", request=1):
            trace.count("c", 3)

        @trace.span("b")
        def f(x):
            return x + 1

        assert f(1) == 2
        for kind in ("train", "mixed", "hard_neg"):
            _train_loop(kind, 3).run()
        fast_score_matrix(scorer_model, _eval_ds(), T_B, R_B, txt_tile=4,
                          img_tile=2, dtype="float32")
    entered.assert_not_called()
    assert trace.snapshot() == before
    # an off site hands back one object per name: nothing allocated a call
    assert trace.span("a") is trace.span("a", request=2)


@pytest.mark.parametrize("kind", ["train", "mixed", "hard_neg"])
def test_loop_spans_nest_share_the_step_and_reach_the_trace(tmp_path, kind,
                                                            caplog):
    """``--profile_dir``'s window (steps 4-5 of a 6-step run) is a session:
    its steps are ``loop.step`` ranges of the trace, each ``optim.step``
    sits under its ``loop.step`` with that step's request, and closing the
    window logs the spans."""
    import logging

    prof = tmp_path / "prof"
    with caplog.at_level(logging.INFO):
        _train_loop(kind, 6, profile_dir=str(prof)).run()
    snap = trace.snapshot()
    steps = _by_name(snap, "loop.step")
    assert [s["request"] for s in steps] == [3, 4]
    # the first window step waited on its batch before the session began
    assert [s["request"] for s in _by_name(snap, "loop.feed_wait")] == [4]
    opt = _by_name(snap, "optim.step")
    assert len(opt) == 2
    for o in opt:
        parent = snap["spans"][o["parent"]]
        assert parent["name"] == "loop.step"
        assert o["request"] == parent["request"]
        assert parent["self_ns"] == (parent["end_ns"] - parent["start_ns"]
                                     - (o["end_ns"] - o["start_ns"]))
    assert _by_name(snap, "loop.readback")
    assert all(s["thread"] == threading.main_thread().name for s in steps)
    assert snap["totals"]["loop.step"]["n"] == 2
    files = os.listdir(prof)
    assert len(files) == 1
    with open(prof / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"loop.step", "optim.step", "loop.feed_wait"} <= names
    assert sum(e.get("name") == "loop.step"
               and e.get("cat") == "user_annotation" for e in events) == 2
    assert "span loop.step: 2," in caplog.text


def test_prefetch_put_is_recorded_on_the_prefetch_thread():
    from uniter_tpu_torch.data.loader import DevicePrefetcher

    trace.span("off")
    with _session():
        it = DevicePrefetcher(iter(range(5)), lambda x: x * 2, depth=2)
        assert list(it) == [0, 2, 4, 6, 8]
        it.close()
    puts = _by_name(trace.snapshot(), "prefetch.put")
    assert len(puts) == 5
    assert {p["thread"] for p in puts} == {"prefetch"}
    assert all(p["parent"] is None for p in puts)


def test_a_new_session_starts_a_fresh_store():
    trace.span("off")
    with _session():
        with trace.span("first"):
            trace.count("n", 2)
    with trace.span("between"):  # off: no record, the store goes stale
        pass
    snap = trace.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["first"]
    assert snap["counts"] == {"n": 2}
    with _session():
        with trace.span("second"):
            trace.count("n", 5)
    snap = trace.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["second"]
    assert snap["counts"] == {"n": 5}


def test_spans_past_the_cap_are_counted(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    trace.span("off")
    with _session():
        with trace.span("root", request=9):
            for _ in range(4):
                with trace.span("leaf"):
                    pass
    snap = trace.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["root", "leaf", "leaf"]
    assert snap["counts"] == {"trace.dropped": 2}
    assert [s["request"] for s in snap["spans"]] == [9, 9, 9]


def _score_spans(snap, n_tiles):
    (root,) = _by_name(snap, "itm.score")
    at = snap["spans"].index(root)
    for name in ("itm.build_arrays", "itm.upload", "itm.readback"):
        (s,) = _by_name(snap, name)
        assert s["parent"] == at and s["request"] == root["request"]
    tiles = _by_name(snap, "itm.tile")
    assert len(tiles) == n_tiles
    assert all(t["parent"] == at and t["request"] == root["request"]
               for t in tiles)
    return root


def _scorer_call(scorer_model, which, txt_chunk=4):
    from uniter_tpu_torch.utils.itm_fast import (fast_score_matrix,
                                                 fast_windowed_scores)

    if which == "matrix":
        return fast_score_matrix(scorer_model, _eval_ds(), T_B, R_B,
                                 txt_tile=txt_chunk, img_tile=2,
                                 dtype="float32")[0]
    return fast_windowed_scores(scorer_model, _eval_ds(bs=2), T_B, R_B,
                                txt_chunk=txt_chunk, dtype="float32")[0]


# the windowed view's real pairs: each caption's length (+ 2) twice, and
# the region counts (R-capped) of its window of 2 images from its own
# (i % 3)
NBB_R = [2, 6, 6]
WINDOWS = sum(NBB_R[i % 3] + NBB_R[(i + 1) % 3] for i in range(5))


@pytest.mark.parametrize("which,shape,n_tiles,counts", [
    # a 5 x 3 matrix in tiles of 4 x 2: the texts padded to 8 rows and the
    # images to 4, so 4 tiles of 8 pairs, 14 slots a pair; the real pairs
    # hold every caption length (+ 2) against each image and every region
    # count (R-capped) against each caption; 4 residual tails a tile
    # (layer 0 and the CLS layer), an embedding tail a text tile and an
    # image chunk: all plain on the CPU
    ("matrix", (5, 3), 4, {"itm.slots": 8 * 4 * 14,
                           "itm.valid_slots": 3 * 25 + 5 * 14,
                           "tail.plain": 4 * 4 + 2 + 2}),
    # 5 captions in chunks of 4 (padded to 8), each against its window of 2
    # images: 8 x 2 pairs of 14 slots; a chunk: its text tail and 4
    # residual tails; the image corpus in one chunk
    ("windowed", (5, 2), 2, {"itm.slots": 8 * 2 * 14,
                             "itm.valid_slots": 2 * 25 + WINDOWS,
                             "tail.plain": 2 * (1 + 4) + 1})])
def test_scorer_spans_nest_and_count_the_slots(scorer_model, tmp_path, which,
                                               shape, n_tiles, counts):
    """Each scorer's call is one ``itm.score`` with its children
    (``_score_spans``), in the session and in the exported trace, and
    counts the slots by hand; the next call is the next request."""
    trace.span("off")
    with _session() as p:
        mat = _scorer_call(scorer_model, which)
    assert mat.shape == shape
    snap = trace.snapshot()
    first = _score_spans(snap, n_tiles)
    assert snap["counts"] == counts
    path = str(tmp_path / "trace.json")
    p.export_chrome_trace(path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"itm.score", "itm.build_arrays", "itm.upload", "itm.tile",
            "itm.readback"} <= names
    trace.span("off")
    with _session():
        _scorer_call(scorer_model, which)
    assert _score_spans(trace.snapshot(), n_tiles)["request"] == \
        first["request"] + 1


def test_windowed_scorer_counts_the_slots(scorer_model):
    """5 captions in chunks of 2 (padded to 6), each against its window of
    2 images from its own (i % 3): 6 x 2 pairs of 14 slots; the real pairs
    add twice each caption's length and its window's region counts, the
    padding row none."""
    trace.span("off")
    with _session():
        mat = _scorer_call(scorer_model, "windowed", txt_chunk=2)
    assert mat.shape == (5, 2)
    assert trace.snapshot()["counts"] == {
        "itm.slots": 6 * 2 * 14, "itm.valid_slots": 2 * 25 + WINDOWS,
        # 3 chunks: a text tail and 4 residual tails each; the image
        # corpus in one chunk
        "tail.plain": 3 * (1 + 4) + 1}


def test_threads_lose_no_span_or_count():
    """More threads than cores record at once with a short switch
    interval: every span and count arrives, each under its own thread's
    parent."""
    n_threads, n_iter = 2 * (os.cpu_count() or 4), 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        trace.span("off")
        with _session():
            def work(k):
                for i in range(n_iter):
                    with trace.span("outer", request=(k, i)):
                        with trace.span("inner"):
                            trace.count("n")

            threads = [threading.Thread(target=work, args=(k,),
                                        name=f"w{k}")
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = trace.snapshot()
    assert snap["counts"] == {"n": n_threads * n_iter}
    inner = _by_name(snap, "inner")
    assert len(inner) == len(_by_name(snap, "outer")) == n_threads * n_iter
    for s in inner:
        parent = snap["spans"][s["parent"]]
        assert parent["name"] == "outer"
        assert parent["thread"] == s["thread"] == f"w{s['request'][0]}"
        assert parent["request"] == s["request"]
