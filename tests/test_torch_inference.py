"""The port's VQA inference CLI against the JAX package's, end to end on the
CPU.

The fixture is the synthetic DB pair of tests/test_e2e_tasks.py, with a
training directory written directly (no training): ``log/hps.json`` as a
TPU run stores it (``attention_impl="pallas"``), ``log/model.json``, and
random weights saved through the JAX package's ``save_params_msgpack``.
``inf_vqa.main`` (JAX) and ``python -m uniter_tpu_torch.inf_vqa --device
cpu`` must write the same ``results.json`` exactly, and ``logits.npz``
within atol 1e-3 (the rows are stored fp16, whose step is ~1e-3 at the
logits' magnitude). The port's data layer must collate the same batches
as the JAX package's, and the port must import without jax.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

torch.set_num_threads(2)

IMG_DIM = 2048
N_ANS = 7


def _run(args, **kw):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from uniter_tpu.config import UniterConfig
    from uniter_tpu.data import write_img_db, write_txt_db
    from uniter_tpu.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu.utils.save import save_params_msgpack

    root = tmp_path_factory.mktemp("torch_inf")
    rng = np.random.RandomState(0)
    img_names = [f"coco_{i:06d}.npz" for i in range(6)]
    img_records = {}
    for n in img_names:
        nbb = rng.randint(5, 10)
        img_records[n] = dict(
            features=rng.randn(nbb, IMG_DIM).astype(np.float16),
            norm_bb=rng.rand(nbb, 6).astype(np.float16),
            conf=np.linspace(1, 0.3, nbb).astype(np.float16),
            soft_labels=rng.rand(nbb, 1601).astype(np.float16),
        )
    img_dir = str(root / "img")
    write_img_db(img_dir, img_records, conf_th=0.2, max_bb=10, min_bb=3)

    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [104, 300]}
    recs, t2i = {}, {}
    for i in range(24):
        tid = f"q_{i}"
        recs[tid] = dict(
            input_ids=[int(x) for x in
                       rng.randint(110, 300, rng.randint(4, 10))],
            img_fname=img_names[i % 6],
            target={"labels": [int(rng.randint(0, 7))], "scores": [1.0]},
        )
        t2i[tid] = img_names[i % 6]
    txt_dir = str(root / "txt")
    write_txt_db(txt_dir, recs, meta, t2i)

    model_cfg = dict(
        vocab_size=300, hidden_size=48, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=96,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
        hidden_act="gelu", initializer_range=0.02,
    )
    train_dir = root / "vqa_out"
    os.makedirs(train_dir / "log")
    os.makedirs(train_dir / "ckpt")
    with open(train_dir / "log" / "model.json", "w") as f:
        json.dump(model_cfg, f)
    with open(train_dir / "log" / "hps.json", "w") as f:
        json.dump(dict(num_answer=N_ANS, conf_th=0.2, max_bb=10, min_bb=3,
                       num_bb=36, compressed_db=False,
                       attention_impl="pallas"), f)

    cfg = UniterConfig.from_dict(model_cfg, dtype="float32")
    model = UniterForVisualQuestionAnswering(cfg, IMG_DIM, N_ANS)
    b, t, r = 2, 8, 6
    dummy = dict(
        input_ids=np.ones((b, t), np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        img_feat=np.zeros((b, r, IMG_DIM), np.float32),
        img_pos_feat=np.zeros((b, r, 7), np.float32),
        attn_mask=np.ones((b, t + r), np.int32))
    params = model.init({"params": jax.random.PRNGKey(0)}, dummy,
                        False)["params"]
    # spread the weights so answers are well separated: exact agreement of
    # argmax is then a property of the port, not of a near tie
    params = jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.1, x.shape)).astype(
            np.float32), jax.tree.map(np.asarray, dict(params)))
    save_params_msgpack(str(train_dir / "ckpt" / "model_step_3.msgpack"),
                        params)
    return dict(img=img_dir, txt=txt_dir, train_dir=str(train_dir),
                root=str(root))


def _infer_args(env, out):
    return ["--txt_db", env["txt"], "--img_db", env["img"],
            "--train_dir", env["train_dir"], "--output_dir", out,
            "--batch_size", "256", "--save_logits"]


def test_port_inf_vqa_matches_jax(env):
    import inf_vqa

    jax_out = os.path.join(env["root"], "jax_inf")
    inf_vqa.main(inf_vqa.get_parser().parse_args(_infer_args(env, jax_out)))
    port_out = os.path.join(env["root"], "port_inf")
    proc = _run(["-m", "uniter_tpu_torch.inf_vqa",
                 *_infer_args(env, port_out), "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]

    with open(os.path.join(jax_out, "results.json")) as f:
        want = json.load(f)
    with open(os.path.join(port_out, "results.json")) as f:
        got = json.load(f)
    assert len(want) == 24
    jl = np.load(os.path.join(jax_out, "logits.npz"))
    pl = np.load(os.path.join(port_out, "logits.npz"))
    assert sorted(jl.files) == sorted(pl.files)
    for qid in jl.files:
        top2 = np.sort(jl[qid].astype(np.float32))[-2:]
        assert top2[1] - top2[0] > 1e-2, f"{qid}: answers near a tie"
        np.testing.assert_allclose(pl[qid].astype(np.float32),
                                   jl[qid].astype(np.float32), atol=1e-3,
                                   rtol=0)
    assert got == want


def test_port_collates_match_jax(env):
    from uniter_tpu.data.buckets import spec_from_dataset as jspec
    from uniter_tpu.data.img_db import DetectFeatDb as JImg
    from uniter_tpu.data.loader import BucketLoader as JLoader
    from uniter_tpu.data.txt_db import TxtTokDb as JTxt
    from uniter_tpu.data.vqa import VqaDataset as JVqa
    from uniter_tpu_torch.data.buckets import spec_from_dataset
    from uniter_tpu_torch.data.img_db import DetectFeatDb
    from uniter_tpu_torch.data.loader import BucketLoader
    from uniter_tpu_torch.data.txt_db import TxtTokDb
    from uniter_tpu_torch.data.vqa import VqaDataset

    def batches(vqa, txt, img, spec, loader):
        ds = vqa(N_ANS, txt(env["txt"], max_txt_len=-1),
                 img(env["img"], conf_th=0.2, max_bb=10, min_bb=3))
        return list(loader(ds, spec(ds, 64), shuffle=False, drop_last=False))

    want = batches(JVqa, JTxt, JImg, jspec, JLoader)
    got = batches(VqaDataset, TxtTokDb, DetectFeatDb, spec_from_dataset,
                  BucketLoader)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype and np.array_equal(g[k], v), k
            else:
                assert g[k] == v, k


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import uniter_tpu_torch, uniter_tpu_torch.inf_vqa\n"
        "import uniter_tpu_torch.data.loader, uniter_tpu_torch.ops.attention\n"
        "import uniter_tpu_torch.data.vqa, uniter_tpu_torch.models.checkpoint\n"
        "import uniter_tpu_torch.train_vqa, uniter_tpu_torch.training.loop\n"
        "import uniter_tpu_torch.models.losses\n"
        "import uniter_tpu_torch.train_nlvr2, uniter_tpu_torch.inf_nlvr2\n"
        "import uniter_tpu_torch.ops.fused_block, uniter_tpu_torch.models.heads\n"
        "import uniter_tpu_torch.models.nlvr2, uniter_tpu_torch.data.nlvr2\n"
        "import uniter_tpu_torch.pretrain, uniter_tpu_torch.models.pretrain\n"
        "import uniter_tpu_torch.ops.ot, uniter_tpu_torch.ops.layer_norm\n"
        "import uniter_tpu_torch.data.mlm, uniter_tpu_torch.data.mrm\n"
        "import uniter_tpu_torch.data.itm, uniter_tpu_torch.ops.ffn\n"
        "import uniter_tpu_torch.models.itm, uniter_tpu_torch.train_itm\n"
        "import uniter_tpu_torch.inf_itm, uniter_tpu_torch.utils.itm_fast\n"
        "import uniter_tpu_torch.train_itm_hard_negatives\n"
        "import uniter_tpu_torch.utils.itm_eval\n"
        "import uniter_tpu_torch.train_ve, uniter_tpu_torch.data.ve\n"
        "import uniter_tpu_torch.train_re, uniter_tpu_torch.inf_re\n"
        "import uniter_tpu_torch.data.re, uniter_tpu_torch.models.re\n"
        "import uniter_tpu_torch.train_vcr, uniter_tpu_torch.inf_vcr\n"
        "import uniter_tpu_torch.data.vcr, uniter_tpu_torch.models.vcr\n"
        "import uniter_tpu_torch.pretrain_vcr\n"
        "import uniter_tpu_torch.parallel.collectives\n"
        "import uniter_tpu_torch.parallel.mesh\n"
        "import uniter_tpu_torch.data.pretrain_vcr\n"
        "import uniter_tpu_torch.models.pretrain_vcr\n"
        "import uniter_tpu_torch.prepro, uniter_tpu_torch.convert_imgdir\n"
        "import uniter_tpu_torch.data.tokenizer\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'uniter_tpu',\n"
        "                              'transformers')]\n"
        "assert not bad, bad\n"
        "assert 'msgpack' not in sys.modules\n"
        "print('ok')\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
