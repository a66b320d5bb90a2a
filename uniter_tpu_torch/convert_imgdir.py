"""npz feature dir -> img_db (port of ``scripts/convert_imgdir.py``,
reference scripts/convert_imgdir.py).

    python -m uniter_tpu_torch.convert_imgdir --img_dir NPZ_DIR \\
        --output IMG_DB [--conf_th 0.2 --max_bb 100 --min_bb 10]

Reads Faster R-CNN npz dumps (``features`` / ``norm_bb`` / ``conf`` /
``soft_labels``), downcasts fp32 to fp16 (:41-46), and writes the store and
its nbb json through ``data/img_db.py`` ``write_img_db``, which counts each
image's regions by the conf-threshold rule (:25). The files are read by a
pool of ``--nproc`` spawned workers and streamed to the writer in sorted
name order.
"""

from __future__ import annotations

import argparse
import glob
import multiprocessing
import os

import numpy as np

from uniter_tpu_torch.utils.logger import LOGGER


def load_npz(path):
    """(file name, record) with every fp32 array cast to fp16."""
    name = os.path.basename(path)
    # the dumps hold plain arrays, not objects: nothing is unpickled
    with np.load(path, allow_pickle=False) as z:
        rec = {}
        for k in z.files:
            arr = z[k]
            if arr.dtype == np.float32:
                arr = arr.astype(np.float16)
            rec[k] = arr
    return name, rec


def main(opts):
    from uniter_tpu_torch.data.img_db import write_img_db

    paths = sorted(glob.glob(os.path.join(opts.img_dir, "*.npz")))
    LOGGER.info("converting %d npz files", len(paths))
    if opts.num_bb is None:
        opts.num_bb = 100 if opts.conf_th == -1 else 36
    with multiprocessing.get_context("spawn").Pool(opts.nproc) as pool:
        # imap keeps only the in-flight window resident: a full split's
        # features are tens of GB
        records = pool.imap(load_npz, paths, chunksize=16)
        write_img_db(opts.output, records, conf_th=opts.conf_th,
                     max_bb=opts.max_bb, min_bb=opts.min_bb,
                     num_bb=opts.num_bb,
                     compress=opts.compress and not opts.uncompressed,
                     store_format=opts.store)
    LOGGER.info("wrote img_db to %s", opts.output)


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--img_dir", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--conf_th", type=float, default=0.2)
    parser.add_argument("--max_bb", type=int, default=100)
    parser.add_argument("--min_bb", type=int, default=10)
    parser.add_argument("--num_bb", type=int, default=None,
                        help="gt layout store name when --conf_th -1 "
                             "(default 100, matching the readers)")
    parser.add_argument("--nproc", type=int, default=8)
    parser.add_argument("--store", default="lmdb", choices=["lmdb", "dir"],
                        help="record store format (lmdb = a real data.mdb "
                             "via the native streaming builder, the "
                             "reference's on-disk format; dir = one file "
                             "per key for debugging)")
    parser.add_argument("--compress", action="store_true",
                        help="write the *_compressed (npz) store layout "
                             "(reference scripts/convert_imgdir.py:128; "
                             "default matches the released uncompressed "
                             "msgpack DBs)")
    parser.add_argument("--uncompressed", action="store_true",
                        help="deprecated: uncompressed is already the "
                             "default; when given it takes precedence "
                             "over --compress")
    return parser


if __name__ == "__main__":
    main(get_parser().parse_args())
