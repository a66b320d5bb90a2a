"""Tokenized-text DB (reference TxtLmdb/TxtTokLmdb, data/data.py:138-215).

Records are lz4-frame-compressed msgpack; sidecar JSONs: ``meta.json``
(CLS/SEP/MASK ids + v_range), ``id2len.json`` (length filter),
``txt2img.json`` / ``img2txts.json`` (pairing). Format-compatible with
released UNITER txt DBs. ``msgpack`` is imported where a record is read or
written, so the modules that subclass ``TxtTokDb`` import without it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from uniter_tpu_torch.data import lz4f
from uniter_tpu_torch.data.store import KVStore, open_store


class TxtDb:
    """Raw record access: lz4(msgpack) values (reference TxtLmdb)."""

    def __init__(self, db_dir: str, readonly: bool = True,
                 store: Optional[KVStore] = None):
        self.db_dir = db_dir
        self.store = store or open_store(db_dir, create=not readonly)
        self.readonly = readonly

    def __getitem__(self, key: str):
        from uniter_tpu_torch.data import msgpack_numpy as msgnp

        # view(): zero-copy value read on lmdbx stores (decompress consumes
        # the buffer immediately; the owned-bytes copy was pure overhead)
        return msgnp.unpackb(lz4f.decompress(self.store.view(key)))

    def __setitem__(self, key: str, value):
        if self.readonly:
            raise ValueError("readonly text DB")
        from uniter_tpu_torch.data import msgpack_numpy as msgnp

        self.store.put(key, lz4f.compress(msgnp.packb(value)))

    def keys(self):
        return self.store.keys()


class TxtTokDb(TxtDb):
    """Tokenized text DB with meta + length filtering (TxtTokLmdb)."""

    def __init__(self, db_dir: str, max_txt_len: int = 60,
                 id2len_file: str = "id2len.json", **kw):
        super().__init__(db_dir, readonly=True, **kw)
        with open(os.path.join(db_dir, id2len_file)) as f:
            id2len = json.load(f)
        if max_txt_len == -1:
            self.id2len = id2len
        else:
            self.id2len = {
                i: l for i, l in id2len.items() if l <= max_txt_len
            }
        with open(os.path.join(db_dir, "meta.json")) as f:
            meta = json.load(f)
        self.cls_ = meta["CLS"]
        self.sep = meta["SEP"]
        self.mask = meta["MASK"]
        self.v_range = meta["v_range"]

    def combine_inputs(self, *inputs) -> np.ndarray:
        """[CLS] ids0 [SEP] ids1 [SEP] ... (data/data.py:201-205)."""
        out = [self.cls_]
        for ids in inputs:
            out.extend(list(ids) + [self.sep])
        return np.asarray(out, dtype=np.int32)

    @property
    def txt2img(self) -> Dict[str, str]:
        with open(os.path.join(self.db_dir, "txt2img.json")) as f:
            return json.load(f)

    @property
    def img2txts(self) -> Dict[str, List[str]]:
        with open(os.path.join(self.db_dir, "img2txts.json")) as f:
            return json.load(f)


def write_txt_db(db_dir: str, records: Dict[str, dict], meta: dict,
                 txt2img: Optional[Dict[str, str]] = None,
                 store: str = "dir"):
    """Create a txt DB (test fixtures + prepro output).

    store="lmdb" bulk-writes a data.mdb via the native lmdbx engine (the
    reference's on-disk format); "dir" writes one file per key.
    """
    from uniter_tpu_torch.data import msgpack_numpy as msgnp

    os.makedirs(db_dir, exist_ok=True)
    id2len = {}
    if store == "lmdb":
        from uniter_tpu_torch.data.lmdb_native import LmdbWriter

        with LmdbWriter(db_dir) as w:
            for key in sorted(records):
                rec = records[key]
                w.put(key, lz4f.compress(msgnp.packb(rec)))
                id2len[key] = len(rec["input_ids"])
        db = None
    else:
        db = TxtDb(db_dir, readonly=False)
        for key, rec in records.items():
            db[key] = rec
            id2len[key] = len(rec["input_ids"])
    with open(os.path.join(db_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(db_dir, "id2len.json"), "w") as f:
        json.dump(id2len, f)
    if txt2img is not None:
        with open(os.path.join(db_dir, "txt2img.json"), "w") as f:
            json.dump(txt2img, f)
        img2txts: Dict[str, List[str]] = {}
        for t, im in txt2img.items():
            # NLVR2-style DBs map a text to a *pair* of images
            for one in (im if isinstance(im, list) else [im]):
                img2txts.setdefault(one, []).append(t)
        with open(os.path.join(db_dir, "img2txts.json"), "w") as f:
            json.dump(img2txts, f)
    if db is not None:
        db.store.close()
