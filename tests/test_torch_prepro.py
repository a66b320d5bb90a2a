"""The port's preprocessing against the JAX package's, on the CPU.

* ``data/tokenizer.py``'s WordPiece tokenizer gives
  ``transformers.BertTokenizer``'s tokens and ids on a corpus of
  punctuation, accents, CJK, control characters, words past 100
  characters, words with no full match and the special tokens, cased and
  uncased (skipped where ``transformers`` is absent: the only use of it in
  the port's tests); ``build_tokenizer`` reads a ``vocab.txt`` or a
  directory holding one and refuses a hub name.
* ``python -m uniter_tpu_torch.prepro`` against the root ``prepro.py`` on
  the same fixtures, for each of the six tasks (RE from json and from a
  MAttNet pickle; the LMDB and the dir store): the decoded records equal
  key by key, the JSON side files equal, ``meta.json`` equal but for the
  output path, each package's ``TxtTokDb`` reads the other's DB, and a
  second run on a written DB raises "Found existing DB".
* ``python -m uniter_tpu_torch.convert_imgdir`` against
  ``scripts/convert_imgdir.py`` on one npz dir: both img DBs read back the
  same features, boxes and nbb json.
* ``python -m uniter_tpu_torch.bucket_stats`` against
  ``scripts/bucket_stats.py`` on one DB pair written by the port's
  writers (with and without the img DB, two token budgets): the printed
  report is the same JSON.
"""

import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import prepro as jprepro  # noqa: E402
from test_prepro_tasks import _opts, vocab_path  # noqa: E402,F401
from uniter_tpu_torch import convert_imgdir as pconvert  # noqa: E402
from uniter_tpu_torch import prepro as pprepro  # noqa: E402
from uniter_tpu_torch.data import tokenizer as ptok  # noqa: E402

# ---------------------------------------------------------------- tokenizer

TOK_WORDS = [
    "the", "dog", "cat", "run", "##s", "##ning", "un", "##aff", "##able",
    "café", "cafe", "naive", "naïve", "über", "uber", "ber", "##ber",
    "日", "本", "語", "a", "b", "##b", "σ", "ς", "i", "hello", "world",
    "Hello", "!", "?", ".", ",", "'", "-", "(", ")", "$", "^", "`", "~",
    "¿", "—", "x", "##x", "foo", "bar", "##bar", "[", "]"]
TOK_CORPUS = [
    "The dog runs!", "unaffable", "Hello, world?!", "hello...world",
    "café CAFÉ naïve Über", "ÜBER ueber", "日本語 and 日本",
    "tab\there\nnewline\rreturn", "nul\x00byte", "ctl\x07bell\x1bx",
    "bad�char", "zero​width", "nbsp space　ideo",
    "x" * 101, "x" * 100, "##bar bar##", "qwerty", "dogx",
    "[MASK] [CLS]dog[SEP] [PAD][UNK]", "[mask] [Cls]", "a[MASK]b",
    "$5^2`~", "¿qué?—sí", "ΣΑΣ σας", "İstanbul", "é é", "",
    "   ", "(a)(b)", "don't", "state-of-the-art"]


def _tok_vocab(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + TOK_WORDS
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab), encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("lower", [False, True])
def test_tokenizer_matches_transformers(tmp_path, lower):
    transformers = pytest.importorskip("transformers")
    path = _tok_vocab(tmp_path)
    want = transformers.BertTokenizer(path, do_lower_case=lower)
    got = ptok.BertTokenizer(path, do_lower_case=lower)
    assert got.vocab == dict(want.vocab)
    for text in TOK_CORPUS:
        toks = got.tokenize(text)
        assert toks == want.tokenize(text), text
        assert (got.convert_tokens_to_ids(toks)
                == want.convert_tokens_to_ids(toks)), text
        # prepro's word-wise use
        assert (jprepro.bert_tokenize(want, text)
                == pprepro.bert_tokenize(got, text)), text
    # every kind in the corpus took effect
    assert got.tokenize("x" * 101) == ["[UNK]"]
    assert got.tokenize("qwerty") == ["[UNK]"]
    assert got.tokenize("a[MASK]b") == ["a", "[MASK]", "b"]
    assert got.tokenize("日本語") == ["日", "本", "語"]
    assert got.tokenize("unaffable") == ["un", "##aff", "##able"]


def test_build_tokenizer_reads_local_vocab_only(tmp_path):
    path = _tok_vocab(tmp_path)
    cased = ptok.build_tokenizer(path)
    assert not cased.do_lower_case and cased.tokenize("Über") == ["[UNK]"]
    d = tmp_path / "bert-base-uncased"
    d.mkdir()
    (d / "vocab.txt").write_text(open(path, encoding="utf-8").read(),
                                 encoding="utf-8")
    uncased = ptok.build_tokenizer(str(d))
    assert uncased.do_lower_case and uncased.tokenize("Über") == ["uber"]
    assert not ptok.build_tokenizer(str(tmp_path)).do_lower_case
    with pytest.raises(ValueError, match="local vocabulary"):
        ptok.build_tokenizer("bert-base-cased")
    with pytest.raises(ValueError, match="local vocabulary"):
        pprepro.main(_opts(annotation=path, output=str(tmp_path / "o"),
                           toker="bert-base-cased"))


# ---------------------------------------------------------------- prepro

def _write_fixture(root, task):
    """(annotation path, extra options) of ``task``: the shapes of
    tests/test_prepro_tasks.py, with unknown words, punctuation and
    capitals so that [UNK] and the word splits show."""
    rng = np.random.RandomState(0)
    words = ["what", "color", "is", "the", "dog", "cat", "red", "blue", "a",
             "on", "true", "person", "wearing", "hat", "Dog", "hats",
             "zebra", "dog's", "(red)", "blue?"]

    def sent(n=None):
        return " ".join(rng.choice(words, n or rng.randint(2, 8)))

    extra = {}
    if task == "nlvr":
        lines = [json.dumps({"identifier": f"dev-{i:04d}-{k}-0.png",
                             "sentence": sent(),
                             "label": "True" if (i + k) % 2 else "False"})
                 for i in range(6) for k in range(2)]
        lines.append(json.dumps({"identifier": "test-0000-0-0.png",
                                 "sentence": sent()}))
        ann = root / "nlvr.jsonl"
        ann.write_text("\n".join(lines) + "\n\n")
        missing = root / "missing.json"
        missing.write_text(json.dumps(["nlvr2_dev-0002-1-img1.npz"]))
        extra["missing"] = str(missing)
    elif task == "vqa":
        ann = root / "questions.json"
        ann.write_text(json.dumps({"questions": [
            {"question_id": i, "image_id": i % 3, "question": sent()}
            for i in range(8)]}))
        answers = ["red", "blue", "dog", "zebra"]
        va = root / "annotations.json"
        va.write_text(json.dumps({"annotations": [
            {"question_id": i, "answers": [
                {"answer": answers[int(j)]}
                for j in rng.randint(0, 4, rng.randint(1, 10))]}
            for i in range(8)]}))
        a2l = root / "ans2label.json"
        a2l.write_text(json.dumps({"red": 0, "blue": 1, "dog": 2}))
        extra.update(vqa_annotations=str(va), ans2label=str(a2l))
    elif task == "ve":
        labels = ["entailment", "neutral", "contradiction", "-", None]
        lines = []
        for i in range(10):
            ex = {"pairID": f"p{i}", "Flickr30K_ID": str(100 + i % 3),
                  "sentence2": sent()}
            if labels[i % 5] is not None:
                ex["gold_label"] = labels[i % 5]
            lines.append(json.dumps(ex))
        ann = root / "ve.jsonl"
        ann.write_text("\n".join(lines))
    elif task == "itm":
        ann = root / "caps.json"
        ann.write_text(json.dumps({"annotations": [
            {"id": i, "image_id": (i % 3) if i < 7 else f"img{i}",
             "caption": sent()} for i in range(9)]}))
        extra["img_format"] = "flickr30k_{}.npz"
    elif task == "vcr":
        lines = [json.dumps({
            "annot_id": f"ex{i}", "objects": ["person", "dog"],
            "img_fn": f"movie/{i:04d}.jpg",
            "question": ["what", "is", [0], "wearing", "?"],
            "answer_choices": [["a", "hat"], ["a", "red", "hat"], [[1]],
                               [[0, 90], "Blue"]],
            "rationale_choices": [["true"], [[0], "is", "red"], ["cat"],
                                  ["dog", "on", "hat"]],
            "answer_label": i % 4, "rationale_label": (i + 1) % 4})
            for i in range(4)]
        ann = root / "vcr.jsonl"
        ann.write_text("\n".join(lines))
    else:  # re, json or pickle
        images = [{"id": 10 + i, "file_name": f"{10 + i}.jpg",
                   "height": 480, "width": 640} for i in range(3)]
        anns = [{"id": 1000 + 10 * i + k, "area": 50.0 + k,
                 "bbox": [1.0 * k, 2.0, 30.0, 40.0], "image_id": 10 + i,
                 "category_id": 1 + k % 2}
                for i in range(3) for k in range(3)]
        refs = [{"ref_id": j, "ann_id": 1000 + 10 * (j % 3) + j % 2,
                 "image_id": 10 + j % 3,
                 "split": "train" if j < 4 else "val",
                 "sentences": [{"sent_id": 100 + 2 * j + s, "sent": sent()}
                               for s in range(2)]} for j in range(6)]
        inst = root / "instances.json"
        inst.write_text(json.dumps({
            "images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "dog"},
                           {"id": 2, "name": "cat"}]}))
        iid = root / "iid.json"
        iid.write_text(json.dumps({"iid_to_ann_ids": {
            str(10 + i): [1000 + 10 * i + k for k in range(3)]
            for i in range(3)}}))
        extra.update(instances=str(inst), iid_to_ann_ids=str(iid))
        if task == "re-pickle":
            ann = root / "refs(unc).p"
            with open(ann, "wb") as f:
                pickle.dump(refs, f)
        else:
            ann = root / "refs.json"
            ann.write_text(json.dumps(refs))
    return str(ann), extra


def _records(db_dir):
    from uniter_tpu_torch.data.txt_db import TxtDb

    db = TxtDb(db_dir)
    try:
        return {k: db[k] for k in db.keys()}
    finally:
        db.store.close()


SIDE_FILES = ("id2len", "txt2img", "img2txts", "id2len_qa", "id2len_qar",
              "refs", "annotations", "categories", "images")


@pytest.mark.parametrize("task,store", [
    ("nlvr", "lmdb"), ("vqa", "lmdb"), ("ve", "lmdb"), ("itm", "lmdb"),
    ("vcr", "lmdb"), ("re", "lmdb"), ("re-pickle", "lmdb"),
    ("vqa", "dir")])
def test_prepro_matches_root(tmp_path, vocab_path, task, store):  # noqa: F811
    pytest.importorskip("transformers")  # the root prepro.py's tokenizer
    ann, extra = _write_fixture(tmp_path, task)
    kw = dict(task=task.split("-")[0], toker=vocab_path, store=store,
              **extra)
    out = {}
    for name, mod in (("jax", jprepro), ("port", pprepro)):
        out[name] = str(tmp_path / f"txt_{name}")
        # the port's parser gives both mains every option (meta.json dumps
        # them)
        opts = pprepro.get_parser().parse_args(
            ["--annotation", ann, "--output", out[name]])
        vars(opts).update(kw)
        mod.main(opts)
        with pytest.raises(ValueError, match="Found existing DB"):
            mod.main(opts)
    want, got = (_records(out[n]) for n in ("jax", "port"))
    assert want and sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    files = {n: sorted(os.listdir(out[n])) for n in out}
    assert files["port"] == files["jax"]
    for side in SIDE_FILES:
        if f"{side}.json" in files["jax"]:
            with open(os.path.join(out["jax"], f"{side}.json")) as f:
                w = json.load(f)
            with open(os.path.join(out["port"], f"{side}.json")) as f:
                assert json.load(f) == w, side
    metas = {}
    for n in out:
        with open(os.path.join(out[n], "meta.json")) as f:
            metas[n] = json.load(f)
        assert metas[n].pop("output") == out[n]
    assert metas["port"] == metas["jax"]
    assert metas["port"]["v_range"] == [5, 20]
    assert metas["port"]["task"] == kw["task"]
    # each package reads the other's DB
    from uniter_tpu.data.txt_db import TxtTokDb as JaxDb
    from uniter_tpu_torch.data.txt_db import TxtTokDb as PortDb

    for reader, other in ((JaxDb, "port"), (PortDb, "jax")):
        db = reader(out[other], max_txt_len=-1)
        assert set(db.id2len) == set(want)
        for k in want:
            assert db[k] == want[k], (reader, k)
        assert db.cls_ == 2 and db.sep == 3 and db.mask == 4


# ---------------------------------------------------------------- images

def _root_convert():
    spec = importlib.util.spec_from_file_location(
        "root_convert_imgdir", os.path.join(ROOT, "scripts",
                                            "convert_imgdir.py"))
    mod = importlib.util.module_from_spec(spec)
    # its pool pickles load_npz by module name
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("conf_th", [0.2, -1])
def test_convert_imgdir_matches_root(tmp_path, conf_th):
    rng = np.random.RandomState(0)
    npz = tmp_path / "npz"
    npz.mkdir()
    names = [f"coco_{i:012}.npz" for i in range(5)]
    for n in names:
        nbb = rng.randint(3, 30)
        np.savez(npz / n,
                 features=rng.randn(nbb, 2048).astype(np.float32),
                 norm_bb=rng.rand(nbb, 6).astype(np.float32),
                 conf=np.sort(rng.rand(nbb))[::-1].astype(np.float32),
                 soft_labels=rng.rand(nbb, 1601).astype(np.float32))
    args = ["--img_dir", str(npz), "--conf_th", str(conf_th), "--max_bb",
            "20", "--min_bb", "4", "--nproc", "2"]
    out = {"jax": str(tmp_path / "img_jax"), "port": str(tmp_path / "img")}
    # the root script parses its flags under __main__; they are the port's
    _root_convert().main(pconvert.get_parser().parse_args(
        args + ["--output", out["jax"]]))
    pconvert.main(pconvert.get_parser().parse_args(
        args + ["--output", out["port"]]))
    assert sorted(os.listdir(out["port"])) == sorted(os.listdir(out["jax"]))
    for f in os.listdir(out["jax"]):
        if f.endswith(".json"):
            with open(os.path.join(out["jax"], f)) as a, \
                    open(os.path.join(out["port"], f)) as b:
                assert json.load(a) == json.load(b), f
    from uniter_tpu.data.img_db import DetectFeatDb as JaxImg
    from uniter_tpu_torch.data.img_db import DetectFeatDb as PortImg

    num_bb = 100 if conf_th == -1 else 36
    kw = dict(conf_th=conf_th, max_bb=20, min_bb=4, num_bb=num_bb)
    jdb, pdb = JaxImg(out["jax"], **kw), PortImg(out["port"], **kw)
    assert dict(pdb.name2nbb) == dict(jdb.name2nbb)
    for n in names:
        w, g = jdb.get_dump(n), pdb.get_dump(n)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        with np.load(npz / n) as z:  # the fp32 -> fp16 downcast
            np.testing.assert_array_equal(
                g["features"], z["features"][:len(g["features"])]
                .astype(np.float16))


@pytest.mark.parametrize("budget,with_img", [(256, True), (10240, True),
                                             (512, False)])
def test_bucket_stats_matches_root(tmp_path, budget, with_img):
    import subprocess

    from test_torch_parallel import vqa_dbs
    from uniter_tpu_torch import bucket_stats as pstats

    vqa_dbs(tmp_path)
    args = ["--txt_db", str(tmp_path / "txt"), "--train_batch_size",
            str(budget), "--max_txt_len", "8"]
    if with_img:
        args += ["--img_db", str(tmp_path / "img"), "--max_bb", "10",
                 "--min_bb", "3"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "bucket_stats.py"),
         *args], capture_output=True, text=True, env=env, check=True)
    want = json.loads(root.stdout)
    got = pstats.main(pstats.get_parser().parse_args(args))
    assert got == want
    assert want["n_batches"] > 0 and want["buckets"]
