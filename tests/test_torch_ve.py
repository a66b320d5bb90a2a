"""The port's SNLI-VE entry point against the JAX package, on the CPU.

* ``python -m uniter_tpu_torch.train_ve``'s parser has the root
  ``train_ve.py``'s flags and defaults (3 answers, lr 8e-5, 4000 steps, 400
  warm-up), plus ``--device``.
* ``data/ve.py``'s datasets are the VQA dataset with 3 answers; their
  records and collates equal the JAX package's ``data/ve.py``'s.
* A 3-answer run trains, validates, saves and resumes on the CPU, and
  ``inf_vqa`` answers from it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
torch.set_num_threads(2)

MODEL_CFG = dict(vocab_size=300, hidden_size=48, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=96,
                 max_position_embeddings=64, type_vocab_size=2,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 hidden_act="gelu", initializer_range=0.02)


def test_train_ve_parser_matches_root():
    import train_ve
    from uniter_tpu_torch import train_ve as port

    want = {a.dest: a.default for a in train_ve.get_parser()._actions}
    got = {a.dest: a.default for a in port.get_parser()._actions}
    assert set(got) - set(want) == {"device", "dist_backend"}
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want
    assert (got["num_answer"], got["learning_rate"], got["num_train_steps"],
            got["warmup_steps"]) == (3, 8e-5, 4000, 400)
    assert got["device"] == "cuda" and got["dist_backend"] is None


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """6 images, 18 hypotheses with labels 0-2 (entailment, neutral,
    contradiction), written with the port's writers."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.txt_db import write_txt_db

    root = tmp_path_factory.mktemp("torch_ve")
    rng = np.random.RandomState(0)
    names = [f"flickr_{i:04d}.npz" for i in range(6)]
    imgs = {}
    for n in names:
        nbb = rng.randint(5, 10)
        imgs[n] = dict(features=rng.randn(nbb, 2048).astype(np.float16),
                       norm_bb=rng.rand(nbb, 6).astype(np.float16),
                       conf=np.linspace(1, 0.3, nbb).astype(np.float16),
                       soft_labels=rng.rand(nbb, 1601).astype(np.float16))
    write_img_db(str(root / "img"), imgs, conf_th=0.2, max_bb=10, min_bb=3)
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [104, 300]}
    recs, t2i = {}, {}
    for i in range(18):
        recs[f"h_{i}"] = dict(
            input_ids=[int(x) for x in rng.randint(110, 300,
                                                   rng.randint(4, 12))],
            img_fname=names[i % 6],
            target={"labels": [i % 3], "scores": [1.0]})
        t2i[f"h_{i}"] = names[i % 6]
    write_txt_db(str(root / "txt"), recs, meta, t2i)
    with open(root / "model.json", "w") as f:
        json.dump(MODEL_CFG, f)
    return root


def test_ve_datasets_match_jax(dbs):
    from uniter_tpu.data import ve as jve
    from uniter_tpu.data.buckets import spec_from_dataset as jspec
    from uniter_tpu.data.img_db import DetectFeatDb as JImg
    from uniter_tpu.data.loader import BucketLoader as JLoader
    from uniter_tpu.data.txt_db import TxtTokDb as JTxt
    from uniter_tpu_torch.data import ve, vqa
    from uniter_tpu_torch.data.buckets import spec_from_dataset
    from uniter_tpu_torch.data.img_db import DetectFeatDb
    from uniter_tpu_torch.data.loader import BucketLoader
    from uniter_tpu_torch.data.txt_db import TxtTokDb

    assert ve.VeDataset is vqa.VeDataset and ve.VeEvalDataset is ve.VeDataset

    def batches(mod, txt, img, spec, loader):
        ds = mod.VeEvalDataset(txt(str(dbs / "txt"), max_txt_len=60),
                               img(str(dbs / "img"), conf_th=0.2, max_bb=10,
                                   min_bb=3))
        assert ds.num_answers == 3
        return list(loader(ds, spec(ds, 64), shuffle=False,
                           drop_last=False))

    want = batches(jve, JTxt, JImg, jspec, JLoader)
    got = batches(ve, TxtTokDb, DetectFeatDb, spec_from_dataset,
                  BucketLoader)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype and np.array_equal(g[k], v), k
            else:
                assert g[k] == v, k
    assert got[0]["targets"].shape[1] == 3


def _run(args):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_ve_cli_trains_and_resumes(dbs):
    out = dbs / "run"
    conf = dict(train_txt_db=str(dbs / "txt"), train_img_db=str(dbs / "img"),
                val_txt_db=str(dbs / "txt"), val_img_db=str(dbs / "img"),
                model_config=str(dbs / "model.json"), output_dir=str(out),
                train_batch_size=256, val_batch_size=512, max_bb=10,
                min_bb=3, n_workers=0, warmup_steps=2, valid_steps=2,
                log_steps=1, num_train_steps=3, device="cpu")
    path = str(dbs / "train.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    proc = _run(["-m", "uniter_tpu_torch.train_ve", "--config", path])
    assert proc.returncode == 0, proc.stderr[-3000:]
    weights = torch.load(out / "ckpt" / "model_step_3.pt", weights_only=True)
    assert weights["vqa_output.3.weight"].shape == (3, 96)
    scalars = [json.loads(line) for line in open(out / "log" /
                                                 "scalars.jsonl")]
    assert any("valid/score" in s for s in scalars)
    with open(out / "log" / "hps.json") as f:
        hps = json.load(f)
    assert (hps["num_answer"], hps["learning_rate"]) == (3, 8e-5)

    proc = _run(["-m", "uniter_tpu_torch.train_ve", "--config", path,
                 "--num_train_steps", "5"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed from step 3" in proc.stderr
    assert "model_step_5.pt" in os.listdir(out / "ckpt")

    proc = _run(["-m", "uniter_tpu_torch.inf_vqa", "--txt_db",
                 str(dbs / "txt"), "--img_db", str(dbs / "img"),
                 "--train_dir", str(out), "--output_dir", str(dbs / "ans"),
                 "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(dbs / "ans" / "results.json") as f:
        answers = json.load(f)
    assert sorted(a["question_id"] for a in answers) == sorted(
        f"h_{i}" for i in range(18))
    assert {a["answer"] for a in answers} <= {"0", "1", "2"}
