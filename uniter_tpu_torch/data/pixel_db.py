"""Pixel image store and the BEiT-3 VQA batch.

Beside the region-feature DB (``img_db``): a store of raw images, one
record a name, each uint8 [3, size, size] (channels first, RGB) as raw
bytes in an LMDB (``lmdb_native``), with ``meta.json`` giving the size
and channels.

``collate_beit3`` makes the batch ``models.beit3`` reads: each distinct
image of the batch once (``pixel_values`` uint8 [n_img, 3, size, size], in
first-appearance order) and ``img_index`` [pairs] into it; ``input_ids``
[pairs, T] (bos, the question's tokens, eos; padded with ``pad_id`` to the
longest, rounded up to a multiple of ``multiple``) and ``text_mask``
[pairs, T] (1 at real tokens); ``qids``.

``Beit3VqaDataset`` pairs a tokenized txt DB (``txt_db.TxtTokDb``: each
record's ``input_ids`` without specials, ``txt2img.json``) with a pixel
store; ``Beit3BatchLoader`` walks it in order, one process, in batches.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable, List, Tuple

import numpy as np

from uniter_tpu_torch.data.store import open_store

META = "meta.json"


def write_pixel_db(path: str, images: Iterable[Tuple[str, np.ndarray]]
                   ) -> str:
    """Write ``images`` ((name, uint8 [3, size, size]) pairs) to ``path``
    as an LMDB, and ``meta.json``."""
    items = sorted(images, key=lambda kv: kv[0])
    if not items:
        raise ValueError("no images to write")
    shape = items[0][1].shape
    if len(shape) != 3 or shape[1] != shape[2]:
        raise ValueError(f"images are [C, S, S] arrays, got {shape}")
    for name, img in items:
        if img.shape != shape or img.dtype != np.uint8:
            raise ValueError(f"{name}: {img.shape} {img.dtype}, not uint8 "
                             f"{shape}")
    from uniter_tpu_torch.data.lmdb_native import LmdbWriter

    with LmdbWriter(path) as w:
        for name, img in items:
            w.put(name, np.ascontiguousarray(img).tobytes())
    with open(os.path.join(path, META), "w") as f:
        json.dump({"channels": int(shape[0]), "size": int(shape[1])}, f)
    return path


class PixelDb:
    """Read side of ``write_pixel_db``: ``get(name)`` is the image as a
    uint8 [C, size, size] array."""

    def __init__(self, path: str):
        with open(os.path.join(path, META)) as f:
            meta = json.load(f)
        self.shape = (meta["channels"], meta["size"], meta["size"])
        self.store = open_store(path)

    def get(self, name: str) -> np.ndarray:
        raw = self.store.view(name)
        img = np.frombuffer(raw, np.uint8)
        if img.size != int(np.prod(self.shape)):
            raise ValueError(f"{name}: {img.size} bytes, not {self.shape}")
        return img.reshape(self.shape).copy()


def collate_beit3(records: List[dict], get_pixels: Callable[[str], np.ndarray],
                  pad_id: int = 1, multiple: int = 8) -> dict:
    """The batch of ``records`` (each ``input_ids``: bos .. eos, ``img``:
    the image's name, ``qid``); ``get_pixels(name)`` gives an image."""
    names = list(dict.fromkeys(r["img"] for r in records))
    slot = {n: i for i, n in enumerate(names)}
    longest = max(len(r["input_ids"]) for r in records)
    t = -(-longest // multiple) * multiple
    ids = np.full((len(records), t), pad_id, np.int64)
    mask = np.zeros((len(records), t), np.int64)
    for i, r in enumerate(records):
        n = len(r["input_ids"])
        ids[i, :n] = r["input_ids"]
        mask[i, :n] = 1
    return {"pixel_values": np.stack([get_pixels(n) for n in names]),
            "img_index": np.asarray([slot[r["img"]] for r in records],
                                    np.int64),
            "input_ids": ids, "text_mask": mask,
            "qids": [r["qid"] for r in records]}


class Beit3VqaDataset:
    """Questions of a txt DB over the images of a pixel store, in the txt
    DB's order; each record's tokens get ``bos`` and ``eos``."""

    def __init__(self, txt_db, pixel_db: PixelDb, bos: int, eos: int):
        self.txt_db = txt_db
        self.pixel_db = pixel_db
        self.ids = list(txt_db.id2len.keys())
        self.img = txt_db.txt2img
        self.bos, self.eos = bos, eos

    def __len__(self):
        return len(self.ids)

    def record(self, i: int) -> dict:
        qid = self.ids[i]
        toks = np.asarray(self.txt_db[qid]["input_ids"], np.int64)
        return {"input_ids": np.concatenate([[self.bos], toks, [self.eos]]),
                "img": self.img[qid], "qid": qid}


class Beit3BatchLoader:
    """``dataset`` in order, ``batch_size`` questions a batch
    (``collate_beit3``), one pass."""

    def __init__(self, dataset: Beit3VqaDataset, batch_size: int,
                 pad_id: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_id = pad_id

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        ds = self.dataset
        for i0 in range(0, len(ds), self.batch_size):
            recs = [ds.record(i)
                    for i in range(i0, min(i0 + self.batch_size, len(ds)))]
            yield collate_beit3(recs, ds.pixel_db.get, self.pad_id)
