"""Static length-bucketed batching — the XLA-native replacement for the
reference's TokenBucketSampler (data/sampler.py:16-61).

The reference shuffles, sorts within 8192-example buckets, and packs batches
to a token budget with per-batch max-length padding — a new tensor shape
every batch, which would force an XLA recompile each step. Here every batch
has one of a small, fixed set of shapes:

  * txt length and region count are rounded up to bucket boundaries
    (T in txt_buckets, R in img_buckets);
  * each (T, R) bucket gets a fixed batch size derived from the token
    budget, rounded to a multiple of ``size_mul`` (the reference's
    tensor-core multiple-of-8 rule, sampler.py:31-57, maps to TPU 8-sublane
    alignment);
  * under-filled batches are padded with zero-weight rows (``ex_weight``).

So at most |txt_buckets| x |img_buckets| programs are compiled, once, and
reused for the whole run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    txt_buckets: Tuple[int, ...] = (32, 64, 96, 128)
    img_buckets: Tuple[int, ...] = (20, 40, 64, 100)
    token_budget: int = 10240  # reference train_batch_size in tokens
    size_mul: int = 8
    min_batch: int = 8

    def txt_bucket(self, txt_len: int) -> int:
        for b in self.txt_buckets:
            if txt_len <= b:
                return b
        return self.txt_buckets[-1]

    def img_bucket(self, nbb: int) -> int:
        for b in self.img_buckets:
            if nbb <= b:
                return b
        return self.img_buckets[-1]

    def bucket_for(self, txt_len: int, nbb: int) -> Tuple[int, int]:
        return self.txt_bucket(txt_len), self.img_bucket(nbb)

    def batch_size(self, bucket: Tuple[int, int]) -> int:
        """Rows per batch: token budget, floored to a multiple of size_mul.
        size_mul must cover both hardware alignment (8) and the data-parallel
        shard count x rows-per-example so every device gets whole examples."""
        t, r = bucket
        b = self.token_budget // (t + r)
        b = (b // self.size_mul) * self.size_mul
        return max(b, self.size_mul, self.min_batch)


def size_multiple(rows: int, world: int) -> int:
    """Batch rows come in multiples of this: ``max(8, rows x world)``, the
    JAX driver's rule, so that over ``world`` processes every rank takes
    whole examples of ``rows`` rows; where that is not a multiple of rows
    x world (3-row examples over 2 ranks), the least common multiple."""
    m = rows * world
    mul = max(8, m)
    return mul if world == 1 or mul % m == 0 else math.lcm(8, m)


def spec_from_dataset(dataset, token_budget: int,
                      size_mul: int = 0) -> BucketSpec:
    """BucketSpec whose grid covers the dataset's real (txt, region) sizes —
    nothing is ever truncated. The default size_mul accounts for the
    dataset's rows_per_example and the number of processes that share each
    batch (``size_multiple``)."""
    if not size_mul:
        from uniter_tpu_torch.parallel.collectives import num_processes

        size_mul = size_multiple(getattr(dataset, "rows_per_example", 1),
                                 num_processes())
    sizes = [dataset.size_of(i) for i in range(len(dataset))]
    max_t = max((s[0] for s in sizes), default=32)
    max_r = max((s[1] for s in sizes), default=4)
    cap_t = ((max_t + 7) // 8) * 8
    cap_r = ((max_r + 3) // 4) * 4
    txt = tuple(b for b in (32, 64, 96, 128, 160, 192, 256, 320, 512)
                if b < cap_t) + (cap_t,)
    img = tuple(b for b in (20, 40, 64, 100) if b < cap_r) + (cap_r,)
    return BucketSpec(txt_buckets=txt, img_buckets=img,
                      token_budget=token_budget, size_mul=size_mul)


# Field specs: key -> (segment, pad_value). Segment in
# {"txt", "img", "none"} controls which bucket axis pads the field.
FieldSpec = Dict[str, Tuple[str, float]]


def collate_joint(
    records: Sequence[dict],
    t_bucket: int,
    r_bucket: int,
    batch_size: int,
    fields: Optional[FieldSpec] = None,
) -> Dict[str, np.ndarray]:
    """Build the canonical fixed-shape batch dict from per-example records.

    Each record: input_ids [t] (CLS..SEP), img_feat [r, D], img_pos_feat
    [r, 7], plus task fields. Rows beyond len(records) are zero padding with
    ex_weight 0.
    """
    n = len(records)
    assert n <= batch_size
    feat0 = records[0].get("img_feat")
    d = feat0.shape[1] if feat0 is not None else 0
    # batch dtype follows the records (released stores are fp16: exact in
    # fp32/bf16, half the collate copy bytes — the hot host-side memcpy)
    fdt = feat0.dtype if feat0 is not None else np.float32
    batch = {
        "input_ids": np.zeros((batch_size, t_bucket), np.int32),
        "position_ids": np.broadcast_to(
            np.arange(t_bucket, dtype=np.int32), (batch_size, t_bucket)
        ).copy(),
        "img_feat": np.zeros((batch_size, r_bucket, d), fdt),
        "img_pos_feat": np.zeros((batch_size, r_bucket, 7), np.float32),
        # empty: fully written by the vectorized mask pass below
        "attn_mask": np.empty((batch_size, t_bucket + r_bucket), np.int32),
        "ex_weight": np.zeros((batch_size,), np.float32),
        "txt_lens": np.zeros((batch_size,), np.int32),
        "num_bbs": np.zeros((batch_size,), np.int32),
    }
    extra: Dict[str, List[np.ndarray]] = {k: [] for k in (fields or {})}
    for i, rec in enumerate(records):
        ids = np.asarray(rec["input_ids"], np.int32)
        tl = min(len(ids), t_bucket)
        batch["input_ids"][i, :tl] = ids[:tl]
        feat = rec["img_feat"]
        nbb = 0
        if feat is not None:
            nbb = min(feat.shape[0], r_bucket)
            batch["img_feat"][i, :nbb] = feat[:nbb]
            batch["img_pos_feat"][i, :nbb] = rec["img_pos_feat"][:nbb]
        batch["txt_lens"][i] = tl
        batch["num_bbs"][i] = nbb
        for key in extra:
            extra[key].append(rec.get(key))
    # masks/weights in one vectorized pass (padding rows: len 0 -> mask 0);
    # per-record element assignments were a measurable slice of collate cost
    batch["ex_weight"][:n] = 1.0
    batch["attn_mask"][:, :t_bucket] = (
        np.arange(t_bucket, dtype=np.int32) < batch["txt_lens"][:, None])
    batch["attn_mask"][:, t_bucket:] = (
        np.arange(r_bucket, dtype=np.int32) < batch["num_bbs"][:, None])
    for key, (segment, pad) in (fields or {}).items():
        vals = extra[key]
        ref = next((v for v in vals if v is not None), None)
        if ref is None:
            continue
        ref = np.asarray(ref)
        length = t_bucket if segment == "txt" else (
            r_bucket if segment == "img" else None)
        if length is None:  # per-example scalar/fixed-shape field
            out = np.full((batch_size,) + ref.shape, pad, ref.dtype)
            for i, v in enumerate(vals):
                if v is not None:
                    out[i] = v
        elif ref.ndim == 1:
            out = np.full((batch_size, length), pad, ref.dtype)
            for i, v in enumerate(vals):
                if v is not None:
                    v = np.asarray(v)
                    out[i, : min(len(v), length)] = v[:length]
        else:
            out = np.full((batch_size, length, ref.shape[1]), pad, ref.dtype)
            for i, v in enumerate(vals):
                if v is not None:
                    v = np.asarray(v)
                    out[i, : min(v.shape[0], length)] = v[:length]
        batch[key] = out
    return batch


def slots_from_labels(labels: np.ndarray, n_slots: int, ignore=-1):
    """[B, L] labels with `ignore` at unused positions -> fixed-size slot
    (positions [B, M], targets [B, M]) tensors for the static masked-hidden
    gather (models/pretrain.py)."""
    b, _ = labels.shape
    pos = np.zeros((b, n_slots), np.int32)
    tgt = np.full((b, n_slots), ignore, labels.dtype)
    for i in range(b):
        idx = np.nonzero(labels[i] != ignore)[0][:n_slots]
        pos[i, : len(idx)] = idx
        tgt[i, : len(idx)] = labels[i, idx]
    return pos, tgt


def slots_from_mask(mask: np.ndarray, n_slots: int):
    """[B, L] boolean mask -> (positions [B, M], valid [B, M])."""
    b, _ = mask.shape
    pos = np.zeros((b, n_slots), np.int32)
    valid = np.zeros((b, n_slots), np.float32)
    for i in range(b):
        idx = np.nonzero(mask[i])[0][:n_slots]
        pos[i, : len(idx)] = idx
        valid[i, : len(idx)] = 1.0
    return pos, valid


def bucket_stats(sizes: Sequence[Tuple[int, int]], spec: BucketSpec,
                 rows_per_example: int = 1) -> Dict:
    """Padding-waste report for a dataset under a bucket grid.

    The reference's TokenBucketSampler packs sorted batches to the token
    budget with per-batch max-length padding (high utilization, dynamic
    shapes); static buckets trade some padding for a fixed program count.
    This measures the trade (SURVEY "hard parts": measure padding waste):

      token_efficiency  = real tokens / padded bucket tokens, over a full
                          epoch including tail-batch padding rows
      per-bucket rows   = examples, batches, batch rows, bucket shape
    """
    per: Dict[Tuple[int, int], Dict] = {}
    for tl, nbb in sizes:
        b = spec.bucket_for(tl, nbb)
        d = per.setdefault(b, dict(n=0, real_tokens=0))
        d["n"] += 1
        d["real_tokens"] += tl + nbb
    out = {}
    tot_real = tot_padded = tot_batches = 0
    for (t, r), d in sorted(per.items()):
        rows = max(spec.batch_size((t, r)) // rows_per_example, 1)
        n_batches = -(-d["n"] // rows)  # ceil: tail batch padded, not dropped
        padded = n_batches * rows * rows_per_example * (t + r)
        out[f"{t}x{r}"] = dict(
            examples=d["n"], batch_examples=rows, batches=n_batches,
            token_efficiency=round(d["real_tokens"] / padded, 4))
        tot_real += d["real_tokens"]
        tot_padded += padded
        tot_batches += n_batches
    return dict(
        buckets=out,
        n_programs=len(out),
        n_batches=tot_batches,
        token_efficiency=round(tot_real / max(tot_padded, 1), 4),
    )
