"""Base dataset machinery (reference data/data.py:218-312).

``JointDataset`` pairs a txt DB with an img DB and precomputes
``lens = txt_len + nbb`` for bucket assignment (data/data.py:228-252).
Multi-host sharding replaces the reference's
``ids[hvd.rank()::hvd.size()]`` (data/data.py:218-225) with
``ids[shard_index::shard_count]``.

The DB classes are imported for annotations only, so the datasets (and
``data.vqa``) import without ``msgpack``; ``ImageDbGroup`` imports
``DetectFeatDb`` where it opens one.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Sequence

import numpy as np

if TYPE_CHECKING:
    from uniter_tpu_torch.data.img_db import DetectFeatDb
    from uniter_tpu_torch.data.txt_db import TxtTokDb


def shard_ids(ids: Sequence, shard_index: int, shard_count: int) -> List:
    return list(ids)[shard_index::shard_count]


class JointDataset:
    def __init__(self, txt_db: TxtTokDb, img_db: Optional[DetectFeatDb],
                 shard_index: int = 0, shard_count: int = 1):
        self.txt_db = txt_db
        self.img_db = img_db
        self.ids = shard_ids(txt_db.id2len.keys(), shard_index, shard_count)
        self.txt_lens = [txt_db.id2len[i] for i in self.ids]
        if img_db is not None:
            txt2img = txt_db.txt2img
            self.img_fnames = [txt2img[i] for i in self.ids]

            def nbb_of(fname):
                # NLVR2-style DBs pair a text with a list of images
                if isinstance(fname, list):
                    return sum(img_db.name2nbb[f] for f in fname)
                return img_db.name2nbb[fname]

            self.lens = [
                tl + nbb_of(fname)
                for tl, fname in zip(self.txt_lens, self.img_fnames)
            ]
        else:
            self.img_fnames = [None] * len(self.ids)
            self.lens = list(self.txt_lens)

    def __len__(self):
        return len(self.ids)

    def example(self, i: int) -> dict:
        return self.txt_db[self.ids[i]]

    def img_feat(self, i: int):
        """(features, 7-d pos, nbb) for example i."""
        return self.img_db.get_img_feat(self.img_fnames[i])

    def size_of(self, i: int):
        """(txt_len_with_specials, nbb) for bucket assignment."""
        nbb = (self.img_db.name2nbb[self.img_fnames[i]]
               if self.img_db is not None else 0)
        return self.txt_lens[i] + 2, nbb  # +2: CLS/SEP added by combine


class ConcatDataset:
    """Multi-corpus concat preserving lens (reference
    ConcatDatasetWithLens, data/data.py:282-295)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.lens = [l for d in self.datasets for l in d.lens]
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def _locate(self, i: int):
        k = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.datasets[k], i - int(self._offsets[k])

    def get_record(self, i: int, rng: np.random.RandomState) -> dict:
        d, j = self._locate(i)
        return d.get_record(j, rng)

    def size_of(self, i: int):
        d, j = self._locate(i)
        return d.size_of(j)

    @property
    def rows_per_example(self) -> int:
        vals = {getattr(d, "rows_per_example", 1) for d in self.datasets}
        assert len(vals) == 1, f"mixed rows_per_example: {vals}"
        return vals.pop()

    def __getattr__(self, name):
        # Fan METHOD calls out to children (reference data/data.py:288-295)
        # — but only for names every child actually has: a catch-all would
        # defeat the loader's getattr/hasattr probes (e.g. a missing
        # new_epoch must look absent, not return a closure that raises
        # mid-epoch).
        if name.startswith("_") or not all(
                hasattr(d, name) for d in self.datasets):
            raise AttributeError(name)

        def run_all(*a, **kw):
            return [getattr(d, name)(*a, **kw) for d in self.datasets]
        return run_all


class ImageDbGroup:
    """img_db cache keyed by path (reference ImageLmdbGroup,
    data/data.py:298-312)."""

    def __init__(self, conf_th=0.2, max_bb=100, min_bb=10, num_bb=36,
                 compress=False):
        self.kw = dict(conf_th=conf_th, max_bb=max_bb, min_bb=min_bb,
                       num_bb=num_bb, compress=compress)
        self.cache = {}

    def __getitem__(self, path: str) -> DetectFeatDb:
        from uniter_tpu_torch.data.img_db import DetectFeatDb

        if path not in self.cache:
            self.cache[path] = DetectFeatDb(path, **self.kw)
        return self.cache[path]
