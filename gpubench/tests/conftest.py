"""A copy of the benchmark in a temporary checkout, with the training
cells (``training_cells.json``, held out of ``BENCHMARK.json``) added and
one tiny configuration with tiny copies of the three mixes, which the
harness finds by name like any other."""

from __future__ import annotations

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 128}
TINY_CORPUS = {"n_img": 40, "regions": [10, 30], "n_txt": 300}
TINY_RECIPE = {"dtype": "float32", "n_workers": 2}
TRAINING_CELLS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "training_cells.json")


def add_training_cells(bench: dict) -> dict:
    """``bench`` with the held-out training cells' entries added."""
    with open(TRAINING_CELLS) as f:
        extra = json.load(f)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + extra[key]
    return bench


def make_checkout(dest: str) -> str:
    """``BENCHMARK.json`` and ``gpubench/`` copied to ``dest`` with the
    training cells, the tiny configuration ``uniter-tiny`` and the cells
    ``tiny-vqa``, ``tiny-pretrain`` and ``tiny-score`` added as files and
    entries alone."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(REPO, "gpubench"),
                    os.path.join(dest, "gpubench"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    g = os.path.join(dest, "gpubench")
    with open(os.path.join(g, "configs", "uniter-base.json")) as f:
        cfg = {**json.load(f), **TINY, "reduced": sorted(TINY)}
    with open(os.path.join(g, "configs", "uniter-tiny.json"), "w") as f:
        json.dump(cfg, f)
    for src, dst, budget, prof in (("vqa-ft-12k", "tiny-vqa", 512, 2),
                                   ("pretrain-20k", "tiny-pretrain", 1024, 4)):
        with open(os.path.join(g, "mixes", src + ".json")) as f:
            mix = json.load(f)
        mix["corpus"].update(TINY_CORPUS)
        if "num_answer" in mix["corpus"]:
            mix["corpus"]["num_answer"] = 50
        mix["recipe"].update(TINY_RECIPE, token_budget=budget)
        mix["window"]["profile_steps"] = prof
        with open(os.path.join(g, "mixes", dst + ".json"), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(g, "mixes", "itm-score-flickr.json")) as f:
        mix = json.load(f)
    mix["corpus"].update(n_img=20, regions=[10, 30], n_txt=40)
    mix["recipe"].update(img_bucket=32, captions_per_call=8, dtype="float32",
                         check_block=10)
    mix["check"]["captions"] = 2
    with open(os.path.join(g, "mixes", "tiny-score.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(dest, "BENCHMARK.json")) as f:
        bench = add_training_cells(json.load(f))
    bench["configs"].append({
        "name": "uniter-tiny", "source": "tests", "reduced": sorted(TINY),
        "file": "gpubench/configs/uniter-tiny.json", "why": "CPU tests"})
    for name, traffic in (("tiny-vqa", "tiny-vqa"),
                          ("tiny-pretrain", "tiny-pretrain"),
                          ("tiny-score", "tiny-score")):
        bench["workloads"].append({"name": name, "config": "uniter-tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            extra = ["tiny-pretrain"] if "base-pretrain" in m["workloads"] \
                else []
            if "large-vqa-ft" in m["workloads"]:
                extra.append("tiny-vqa")
            if "base-itm-score" in m["workloads"]:
                extra.append("tiny-score")
            m["workloads"] = m["workloads"] + extra
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    return make_checkout(str(tmp_path_factory.mktemp("checkout")))


def run_cell(root: str, workload: str, *extra, seed=3000000001,
             seconds=2.0, trace=0, capsys=None):
    """One run of ``workload`` on the CPU through ``gpubench.run.main``
    (the card check skipped); returns (exit code, last stdout line)."""
    from gpubench import run

    code = run.main(["--workload", workload, "--seed", str(seed),
                     "--seconds", str(seconds), "--trace", str(trace),
                     *extra], require_card=False, device="cpu", root=root)
    out = capsys.readouterr().out.strip().splitlines() if capsys else []
    return code, (json.loads(out[-1]) if out else None)
