"""The readers of the port's own spans and counters (``gpubench/spans.py``)
through whole tiny cells on the CPU: a traced run reads each of them, an
untraced run adds nothing to the port's store. The training metrics'
entries (``training_spans.json``) are held out with the training cells and
added here, as ``conftest.py`` adds ``training_cells.json``."""

from __future__ import annotations

import json
import os

import pytest

from gpubench.tests.conftest import make_checkout, run_cell

SCORE = ("host_build_ms_per_call.score", "upload_ms_per_call.score")
TRAIN = ("feed_wait_ms_per_step.train", "h2d_ms_per_batch.train",
         "host_dispatch_ms_per_step.train", "optimizer_ms_per_step.train")
TRAINING_SPANS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "training_spans.json")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = make_checkout(str(tmp_path_factory.mktemp("spans")))
    with open(TRAINING_SPANS) as f:
        extra = json.load(f)["per_layer"]
    for m in extra:
        m["workloads"] = m["workloads"] + ["tiny-vqa", "tiny-pretrain"]
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"] += extra
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


@pytest.mark.parametrize("cell", ["tiny-score", "tiny-vqa", "tiny-pretrain"])
def test_traced_run_reads_every_span_metric(checkout, capsys, cell):
    # a tiny scoring call takes seconds on the CPU: a window long enough
    # that one call falls inside the profiled sub-window
    code, res = run_cell(checkout, cell, trace=1, capsys=capsys,
                         seconds=6.0 if cell == "tiny-score" else 2.0)
    assert code == 0 and res["correct"], res
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in (SCORE if cell == "tiny-score" else TRAIN):
        assert got[name] > 0, (name, got)
        assert res["metrics"][name]["unit"] == "ms"
    if cell == "tiny-score":
        assert 0 < got["pad_share.score"] < 100


def test_untraced_run_adds_no_span(checkout, capsys):
    from uniter_tpu_torch.utils import trace

    run_cell(checkout, "tiny-score", trace=1, capsys=capsys, seconds=6.0)
    before = trace.snapshot()
    assert before["spans"]
    for cell in ("tiny-score", "tiny-vqa"):
        code, res = run_cell(checkout, cell, trace=0, capsys=capsys)
        assert code == 0 and res["correct"], res
    assert trace.snapshot() == before


def test_readers_find_nothing_without_a_profile(checkout):
    """A run with no profiled sub-window reads None from every reader."""
    import types

    from gpubench.harness import Benchmark

    bench = Benchmark(checkout)
    run = types.SimpleNamespace(profile=None, work=[], prof_work=[],
                                window_s=1.0)
    for name in SCORE + TRAIN + ("pad_share.score",):
        assert bench.reader(name)(run) is None
