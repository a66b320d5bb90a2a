"""Annotation preprocessing: raw annotations -> txt_db (port of the root
``prepro.py``, reference prepro.py).

    python -m uniter_tpu_torch.prepro --task vqa --annotation Q.json \\
        --vqa_annotations A.json --output TXT_DB --toker /path/vocab.txt

The same arguments, six tasks and outputs as the root file: NLVR2 jsonl,
VQA questions (+ annotations: soft scores ``min(1, count/3)`` over the
in-tree ``ans2label``), SNLI-VE jsonl, COCO/Flickr captions (``itm``), VCR
jsonl (object mentions become the 81 special ids past the vocabulary;
``id2len_qa.json`` / ``id2len_qar.json``) and referring expressions (json
or a MAttNet ``.p`` pickle, with ``refs``/``annotations``/``categories``/
``images`` json beside the records); ``meta.json`` (``UNK``/``CLS``/
``SEP``/``MASK``/``v_range`` and the options), ``id2len.json``,
``txt2img.json`` and ``img2txts.json``; the records in an LMDB
``data.mdb`` (``--store lmdb``, the reference's format) or one file per
key (``dir``). Words are tokenized one at a time (reference
prepro.py:20-29) by the port's own WordPiece tokenizer
(``data/tokenizer.py``), which reads a local ``vocab.txt`` and never
downloads: ``--toker`` is that file or a directory holding it.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter

from uniter_tpu_torch.data.tokenizer import build_tokenizer as load_tokenizer
from uniter_tpu_torch.utils.logger import LOGGER

# VCR object mentions become per-object special tokens appended after the
# base vocab (the VCR model widens word_embeddings by 81 rows,
# reference model/vcr.py:43-50 / train_vcr.py:37).
VCR_NUM_SPECIAL = 81


def bert_tokenize(tokenizer, text: str):
    """Word-wise WordPiece: tokenize each whitespace word on its own
    (reference prepro.py:20-29)."""
    ids = []
    for word in text.strip().split():
        ws = tokenizer.tokenize(word)
        if ws:
            ids.extend(tokenizer.convert_tokens_to_ids(ws))
    return ids


def process_nlvr2(jsonl, db, tokenize, missing=None):
    id2len, txt2img = {}, {}
    for line in jsonl:
        line = line.strip()
        if not line:
            continue
        example = json.loads(line)
        id_ = example["identifier"]
        img_id = "-".join(id_.split("-")[:-1])
        img_fname = [f"nlvr2_{img_id}-img0.npz", f"nlvr2_{img_id}-img1.npz"]
        if missing and (img_fname[0] in missing or img_fname[1] in missing):
            continue
        input_ids = tokenize(example["sentence"])
        target = ((1 if example["label"] == "True" else 0)
                  if "label" in example else None)
        txt2img[id_] = img_fname
        id2len[id_] = len(input_ids)
        example["input_ids"] = input_ids
        example["img_fname"] = img_fname
        example["target"] = target
        db[id_] = example
    return id2len, txt2img


def process_vqa(questions, annotations, ans2label, db, tokenize,
                img_format="coco_{:012}.npz"):
    """VQA v2 questions (+ optional annotations) -> records with the
    ``{labels, scores}`` target ``data/vqa.py`` reads (score
    ``min(1, count/3)``, the official VQA accuracy weighting)."""
    id2len, txt2img = {}, {}
    for q in questions:
        qid = str(q["question_id"])
        input_ids = tokenize(q["question"])
        img_fname = img_format.format(int(q["image_id"]))
        target = None
        if annotations is not None:
            ann = annotations[int(q["question_id"])]
            counts = Counter(a["answer"] for a in ann["answers"])
            labels, scores = [], []
            for a, c in counts.items():
                if a in ans2label:
                    labels.append(int(ans2label[a]))
                    scores.append(min(1.0, c / 3.0))
            target = {"labels": labels, "scores": scores}
        db[qid] = dict(question_id=q["question_id"], input_ids=input_ids,
                       img_fname=img_fname, target=target)
        id2len[qid] = len(input_ids)
        txt2img[qid] = img_fname
    return id2len, txt2img


def process_ve(jsonl, db, tokenize, img_format="flickr30k_{}.npz"):
    """SNLI-VE jsonl (``sentence2`` hypothesis + ``gold_label``) -> records
    with the 3-way target as ``{labels, scores}`` (VE is 3-answer VQA)."""
    from uniter_tpu_torch.utils.const import VE_ENT2IDX

    id2len, txt2img = {}, {}
    for line in jsonl:
        line = line.strip()
        if not line:
            continue
        ex = json.loads(line)
        id_ = str(ex["pairID"])
        input_ids = tokenize(ex["sentence2"])
        img_fname = img_format.format(str(ex["Flickr30K_ID"]))
        label = ex.get("gold_label")
        target = (None if label in (None, "-")
                  else {"labels": [VE_ENT2IDX[label]], "scores": [1.0]})
        db[id_] = dict(input_ids=input_ids, img_fname=img_fname,
                       target=target)
        id2len[id_] = len(input_ids)
        txt2img[id_] = img_fname
    return id2len, txt2img


def process_captions(captions, db, tokenize, img_format="coco_{:012}.npz"):
    """COCO/Flickr captions (``{'annotations': [{id, image_id, caption}]}``)
    -> ITM/pretraining records, one a caption."""
    id2len, txt2img = {}, {}
    for ann in captions["annotations"]:
        id_ = str(ann["id"])
        input_ids = tokenize(ann["caption"])
        img_fname = (img_format.format(ann["image_id"])
                     if isinstance(ann["image_id"], str)
                     else img_format.format(int(ann["image_id"])))
        db[id_] = dict(input_ids=input_ids, img_fname=img_fname)
        id2len[id_] = len(input_ids)
        txt2img[id_] = img_fname
    return id2len, txt2img


def _tokenize_vcr(mixed, tokenize, vocab_size):
    """VCR token stream: strings are tokenized; object references
    (``[idx, ...]``) map to the special ids ``vocab_size + min(idx, 80)``."""
    ids = []
    for tok in mixed:
        if isinstance(tok, list):
            ids += [vocab_size + min(int(i), VCR_NUM_SPECIAL - 1) for i in tok]
        else:
            ids.extend(tokenize(str(tok)))
    return ids


def process_vcr(jsonl, db, tokenize, vocab_size):
    """VCR jsonl -> records with per-choice token lists, and the
    ``id2len_qa`` / ``id2len_qar`` maps ``VcrTxtTokDb`` buckets by (the
    longest candidate of each)."""
    id2len_qa, id2len_qar, txt2img = {}, {}, {}
    for line in jsonl:
        line = line.strip()
        if not line:
            continue
        ex = json.loads(line)
        id_ = str(ex["annot_id"])
        q = _tokenize_vcr(ex["question"], tokenize, vocab_size)
        a_s = [_tokenize_vcr(a, tokenize, vocab_size)
               for a in ex["answer_choices"]]
        r_s = [_tokenize_vcr(r, tokenize, vocab_size)
               for r in ex.get("rationale_choices", [])]
        img = os.path.splitext(os.path.basename(ex["img_fn"]))[0]
        img_fname = (f"vcr_gt_{img}.npz", f"vcr_{img}.npz")
        db[id_] = dict(
            input_ids=q, input_ids_as=a_s, input_ids_rs=r_s,
            qa_target=int(ex.get("answer_label", -1)),
            qar_target=int(ex.get("rationale_label", -1)),
            img_fname=img_fname)
        max_a = max((len(a) for a in a_s), default=0)
        max_r = max((len(r) for r in r_s), default=0)
        id2len_qa[id_] = len(q) + max_a
        id2len_qar[id_] = len(q) + max_a + max_r
        txt2img[id_] = img_fname
    return id2len_qa, id2len_qar, txt2img


def process_referring_expressions(refs, instances, iid_to_ann_ids, db,
                                  tokenize, split):
    image_set = {r["image_id"] for r in refs if r["split"] == split}
    images = [
        {"id": img["id"], "file_name": img["file_name"],
         "ann_ids": iid_to_ann_ids[str(img["id"])],
         "height": img["height"], "width": img["width"]}
        for img in instances["images"] if img["id"] in image_set
    ]
    annotations = [
        {"id": a["id"], "area": a["area"], "bbox": a["bbox"],
         "image_id": a["image_id"], "category_id": a["category_id"],
         "iscrowd": a.get("iscrowd", 0)}
        for a in instances["annotations"] if a["image_id"] in image_set
    ]
    anns = {a["id"]: a for a in annotations}
    categories = instances["categories"]
    refs = [r for r in refs if r["split"] == split]
    id2len = {}
    for ref in refs:
        img_fname = f"visual_grounding_coco_gt_{int(ref['image_id']):012}.npz"
        for sent in ref["sentences"]:
            input_ids = tokenize(sent["sent"])
            id2len[str(sent["sent_id"])] = len(input_ids)
            db[str(sent["sent_id"])] = {
                "sent_id": sent["sent_id"], "sent": sent["sent"],
                "ref_id": ref["ref_id"], "ann_id": ref["ann_id"],
                "image_id": ref["image_id"],
                "bbox": anns[ref["ann_id"]]["bbox"],
                "input_ids": input_ids, "img_fname": img_fname,
            }
    return id2len, images, annotations, categories, refs


def build_tokenizer(toker_name: str):
    """(tokenize, meta) of a local vocabulary (``data/tokenizer.py``
    ``build_tokenizer``, which refuses a hub name)."""
    toker = load_tokenizer(toker_name)

    def one(tok):
        return toker.convert_tokens_to_ids([tok])[0]

    meta = {"UNK": one("[UNK]"), "CLS": one("[CLS]"), "SEP": one("[SEP]"),
            "MASK": one("[MASK]"), "v_range": [one("!"), len(toker.vocab)],
            "tokenizer": toker_name}
    return (lambda text: bert_tokenize(toker, text)), meta


def _dump_json(out_dir, name, obj, **kw):
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(obj, f, **kw)


def _dump_maps(out_dir, txt2img):
    _dump_json(out_dir, "txt2img", txt2img)
    img2txts = {}
    for t, img in txt2img.items():
        for im in (img if isinstance(img, (list, tuple)) else [img]):
            img2txts.setdefault(im, []).append(t)
    _dump_json(out_dir, "img2txts", img2txts)


def _process(opts, db, tokenize, meta):
    """The task's records into ``db`` and its side files; returns the
    ``id2len`` map."""
    out = opts.output
    task = opts.task
    if task == "nlvr":
        missing = None
        if getattr(opts, "missing", None):
            with open(opts.missing) as f:
                missing = set(json.load(f))
        with open(opts.annotation) as ann:
            id2len, txt2img = process_nlvr2(ann, db, tokenize,
                                            missing=missing)
    elif task == "vqa":
        with open(opts.annotation) as f:
            qs = json.load(f)
        questions = qs["questions"] if isinstance(qs, dict) else qs
        annotations, ans2label = None, {}
        if opts.vqa_annotations:
            from uniter_tpu_torch.utils.vqa_answers import load_ans2label

            with open(opts.vqa_annotations) as f:
                anns = json.load(f)
            anns = anns["annotations"] if isinstance(anns, dict) else anns
            annotations = {int(a["question_id"]): a for a in anns}
            # the in-tree vocabulary unless --ans2label (regenerate with
            # scripts/make_ans2label.py)
            ans2label = load_ans2label(opts.ans2label or None)
        id2len, txt2img = process_vqa(
            questions, annotations, ans2label, db, tokenize,
            img_format=opts.img_format or "coco_{:012}.npz")
    elif task == "ve":
        with open(opts.annotation) as ann:
            id2len, txt2img = process_ve(
                ann, db, tokenize,
                img_format=opts.img_format or "flickr30k_{}.npz")
    elif task == "itm":
        with open(opts.annotation) as f:
            captions = json.load(f)
        id2len, txt2img = process_captions(
            captions, db, tokenize,
            img_format=opts.img_format or "coco_{:012}.npz")
    elif task == "vcr":
        with open(opts.annotation) as ann:
            id2len_qa, id2len_qar, txt2img = process_vcr(
                ann, db, tokenize, vocab_size=meta["v_range"][1])
        _dump_json(out, "id2len_qa", id2len_qa)
        _dump_json(out, "id2len_qar", id2len_qar)
        id2len = id2len_qar  # id2len.json mirrors the longest task
    elif task == "re":
        if opts.annotation.endswith(".p"):
            # the MAttNet refs pickle (refs(unc).p / refs(umd).p) that the
            # reference's create_txtdb_re.sh reads; a file the user names
            import pickle

            with open(opts.annotation, "rb") as f:
                refs = pickle.load(f)
        else:
            with open(opts.annotation) as f:
                refs = json.load(f)
        with open(opts.instances) as f:
            instances = json.load(f)
        with open(opts.iid_to_ann_ids) as f:
            iid_to_ann_ids = json.load(f).get("iid_to_ann_ids")
        id2len, images, annotations, categories, refs = \
            process_referring_expressions(
                refs, instances, iid_to_ann_ids, db, tokenize, opts.split)
        for name, obj in (("refs", refs), ("annotations", annotations),
                          ("categories", categories), ("images", images)):
            _dump_json(out, name, obj)
        return id2len
    else:
        raise ValueError(f"unknown task {task}")
    _dump_maps(out, txt2img)
    return id2len


def main(opts):
    if os.path.exists(opts.output) and os.listdir(opts.output):
        raise ValueError("Found existing DB. Please explicitly remove "
                         "for re-processing")
    os.makedirs(opts.output, exist_ok=True)
    tokenize, meta = build_tokenizer(opts.toker)
    meta.update({k: v for k, v in vars(opts).items() if k != "toker"})
    _dump_json(opts.output, "meta", meta, indent=4)
    if opts.store == "lmdb":
        db = {}  # records held until the bulk write of data.mdb
    else:
        from uniter_tpu_torch.data.txt_db import TxtDb

        db = TxtDb(opts.output, readonly=False)
    try:
        id2len = _process(opts, db, tokenize, meta)
    finally:
        if opts.store != "lmdb":
            db.store.close()
    if opts.store == "lmdb":
        from uniter_tpu_torch.data import lz4f
        from uniter_tpu_torch.data import msgpack_numpy as msgnp
        from uniter_tpu_torch.data.lmdb_native import write_lmdb

        write_lmdb(opts.output, {k: lz4f.compress(msgnp.packb(v))
                                 for k, v in db.items()})
    _dump_json(opts.output, "id2len", id2len)
    LOGGER.info("processed %d examples into %s", len(id2len), opts.output)


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--task", default="nlvr",
                        choices=["nlvr", "re", "vqa", "ve", "itm", "vcr"])
    parser.add_argument("--split", default="train")
    parser.add_argument("--instances", help="RE: instances.json")
    parser.add_argument("--iid_to_ann_ids", help="RE: iid->ann_ids json")
    parser.add_argument("--vqa_annotations",
                        help="VQA: annotations json (omit for test splits)")
    parser.add_argument("--ans2label", help="VQA: answer->label json")
    parser.add_argument("--img_format", default=None,
                        help="img_fname format string, e.g. "
                             "'coco_train2014_{:012}.npz'")
    parser.add_argument("--missing", default=None,
                        help="json list of image fnames absent from the "
                             "img_db (their examples are skipped)")
    parser.add_argument("--toker", default="bert-base-cased",
                        help="a local vocab.txt, or a directory holding "
                             "one (a hub name is refused: nothing is "
                             "downloaded)")
    parser.add_argument("--store", default="lmdb", choices=["lmdb", "dir"],
                        help="record store format (lmdb = reference format)")
    return parser


if __name__ == "__main__":
    main(get_parser().parse_args())
