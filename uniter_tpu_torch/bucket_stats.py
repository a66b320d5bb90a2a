"""Report static-bucket padding efficiency for a txt_db (+ img_db)
(counterpart of ``scripts/bucket_stats.py``).

The reference's TokenBucketSampler (data/sampler.py:16-61) packs
dynamically; the loader's static buckets run one shape per (T, R) bucket.
This prints the measured trade for a real dataset: the number of bucket
shapes, batches per epoch, and token efficiency (real / padded tokens),
from the port's DB readers and ``data/buckets.py`` ``bucket_stats``:

    python -m uniter_tpu_torch.bucket_stats --txt_db ... --img_db ... \\
        --train_batch_size 10240 [--max_txt_len 60]
"""

from __future__ import annotations

import argparse
import json

from uniter_tpu_torch.data.buckets import bucket_stats, spec_from_dataset


def main(opts) -> dict:
    from uniter_tpu_torch.data.img_db import DetectFeatDb
    from uniter_tpu_torch.data.txt_db import TxtTokDb

    txt_db = TxtTokDb(opts.txt_db, max_txt_len=opts.max_txt_len)
    img_db = DetectFeatDb(
        opts.img_db, conf_th=opts.conf_th, max_bb=opts.max_bb,
        min_bb=opts.min_bb, num_bb=opts.num_bb) if opts.img_db else None

    sizes = []
    for i in txt_db.id2len:
        nbb = 0
        if img_db is not None:
            f = txt_db.txt2img[i]
            nbb = (sum(img_db.name2nbb[x] for x in f)
                   if isinstance(f, list) else img_db.name2nbb[f])
        sizes.append((txt_db.id2len[i], nbb))

    class _Sizes:
        def __len__(self):
            return len(sizes)

        def size_of(self, i):
            return sizes[i]

    stats = bucket_stats(sizes, spec_from_dataset(_Sizes(),
                                                  opts.train_batch_size))
    print(json.dumps(stats, indent=2))
    return stats


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--txt_db", required=True)
    p.add_argument("--img_db", default=None)
    p.add_argument("--train_batch_size", type=int, default=10240)
    p.add_argument("--max_txt_len", type=int, default=60)
    p.add_argument("--conf_th", type=float, default=0.2)
    p.add_argument("--max_bb", type=int, default=100)
    p.add_argument("--min_bb", type=int, default=10)
    p.add_argument("--num_bb", type=int, default=36)
    return p


if __name__ == "__main__":
    main(get_parser().parse_args())
