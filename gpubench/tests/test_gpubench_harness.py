"""The harness end to end at tiny sizes on the CPU: cells found by name
from files alone, a sound run reads correct, each fault a training cell
can have and the float8 control read not correct, and no card means no
result. The ``cuda`` test runs the tiny cell on the card."""

from __future__ import annotations

import hashlib
import json
import os

import pytest

from gpubench.tests.conftest import run_cell

CELLS = ("tiny-vqa", "tiny-pretrain")
ALL_CELLS = CELLS + ("tiny-score",)
FAULTS = [(c, f) for c in CELLS for f in ("stale", "half_batch")] + [
    ("tiny-score", "half_batch")]


def _tree_hashes(root):
    out = {}
    for d, _, files in os.walk(root):
        if "cache" in d.split(os.sep) or "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_config_mix_and_metric_are_found_as_files(checkout, capsys):
    """A throwaway metric file and its entry, with the tiny config, mix and
    cell the fixture added, run with no edit to any file that was there."""
    before = _tree_hashes(checkout)
    with open(os.path.join(checkout, "gpubench", "metrics",
                           "rows_per_step.tiny.py"), "w") as f:
        f.write("def read(run):\n"
                "    return sum(w['ex'] for w in run.work) / len(run.work)\n")
    with open(os.path.join(checkout, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "rows_per_step.tiny", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "host feed",
        "moves": "train_ex_per_s", "workloads": ["tiny-vqa"]})
    with open(os.path.join(checkout, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    code, res = run_cell(checkout, "tiny-vqa", trace=1, capsys=capsys)
    assert code == 0 and res["correct"], res
    assert res["metrics"]["rows_per_step.tiny"]["value"] > 0
    after = _tree_hashes(checkout)
    changed = {k for k in before if k != "BENCHMARK.json"
               and after.get(k) != before[k]}
    assert not changed


WANT = {("tiny-score", 0): {"score_pairs_per_s", "setup_s"},
        ("tiny-score", 1): {"mfu.score"}}


@pytest.mark.parametrize("cell", ALL_CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(checkout, capsys, cell, trace):
    code, res = run_cell(checkout, cell, trace=trace, capsys=capsys)
    assert code == 0 and res["correct"], res
    assert res["attempted"] > 0 and res["failed"] == 0
    want = WANT.get((cell, trace)) or (
        {"train_ex_per_s", "train_step_ms_p95", "setup_s"} if not trace
        else {"feed_ms_per_batch.train", "pad_share.train", "mfu.train"})
    assert want <= set(res["metrics"])
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_reads_not_correct(checkout, capsys, cell, fault):
    code, res = run_cell(checkout, cell, "--fault", fault, capsys=capsys)
    assert code == 0 and res["correct"] is False, res


def test_altered_score_reads_not_correct(checkout, capsys, monkeypatch):
    """A scorer that returns one score of each call changed."""
    from uniter_tpu_torch.utils import itm_fast

    exact = itm_fast.fast_score_matrix

    def altered(*a, **kw):
        mat, rest = exact(*a, **kw)
        mat[0, 0] += 1.0
        return mat, rest

    monkeypatch.setattr(itm_fast, "fast_score_matrix", altered)
    code, res = run_cell(checkout, "tiny-score", capsys=capsys)
    assert code == 0 and res["correct"] is False, res


def _control_lines(root, cell, seeds, capsys, **kw):
    from gpubench import run

    code = run.main(["--workload", cell, "--mode", "control", "--seeds",
                     ",".join(str(s) for s in seeds)], root=root, **kw)
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert code == 0 and len(lines) == len(seeds)
    return lines


def _limits(root, cell):
    from gpubench.harness import Benchmark

    bench = Benchmark(root)
    return bench.mix(bench.workload(cell)["traffic"])["check"]["limits"]


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_float8_control_separates_from_the_program(checkout, capsys, cell):
    """At tiny widths the program (float32 on the CPU) stays within the
    cell's limits and the float8 control reads at least ten times it on
    one number (the limits themselves are set at the cells' sizes: the
    ``cuda`` test below)."""
    limits = _limits(checkout, cell)
    for line in _control_lines(checkout, cell, [3000000001], capsys,
                               require_card=False, device="cpu"):
        prog, ctl = line["program"], line["control"]
        assert all(prog[k] <= limits[k] for k in limits), line
        assert any(ctl[k] >= 10 * max(prog[k], 1e-9) for k in ctl
                   if k in limits), line


def test_no_card_no_result(checkout, capsys, monkeypatch):
    import torch

    from gpubench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", "tiny-vqa", "--seed", "1", "--seconds", "1",
                  "--trace", "0"], root=checkout)
    assert exc.value.code == run.EXIT_NO_CARD
    assert capsys.readouterr().out == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["large-vqa-ft", "base-pretrain",
                                  "base-itm-score"])
def test_float8_control_fails_the_cells_limits(card, checkout, capsys,
                                              cell):
    """The control at the cell's own size on three seeds: each fails one
    of the numbers compared (the training cells as ``training_cells.json``
    adds them)."""
    limits = _limits(checkout, cell)
    for line in _control_lines(checkout, cell, [7001, 7002, 7003], capsys):
        assert any(line["control"][k] > limits[k] for k in limits
                   if k in line["control"]), line
        assert all(line["program"][k] <= limits[k] for k in limits), line


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_tiny_cell_on_the_card(card, checkout, capsys, cell):
    from gpubench import run

    code = run.main(["--workload", cell, "--seed", "77", "--seconds", "2",
                     "--trace", "1"], root=checkout)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and res["correct"], res
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
