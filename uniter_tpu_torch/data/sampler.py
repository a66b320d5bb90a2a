"""Samplers: static-bucket batch planning + distributed epoch sampling.

``StaticBucketSampler`` is the TPU analog of the reference's
TokenBucketSampler (data/sampler.py:16-61): it groups example indices by
their static (T, R) bucket, shuffles within groups, and emits
(bucket, index-list) batches of the bucket's fixed batch size. The XLA
program count is bounded by the bucket grid; padding waste replaces
recompiles.

``DistributedSampler`` (epoch-based — reference data/sampler.py:64-121)
pads to divisibility and strides by shard; parity primitive, the in-tree
RE paths shard via the loader plan / eval-dataset split instead.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from uniter_tpu_torch.data.buckets import BucketSpec


class StaticBucketSampler:
    def __init__(
        self,
        sizes: Sequence[Tuple[int, int]],  # per-example (txt_len, nbb)
        spec: BucketSpec,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        rows_per_example: int = 1,
        group: int = 1,
    ):
        self.spec = spec
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.rows_per_example = rows_per_example
        self.group = max(int(group), 1)
        self.buckets: Dict[Tuple[int, int], List[int]] = {}
        for i, (tl, nbb) in enumerate(sizes):
            self.buckets.setdefault(spec.bucket_for(tl, nbb), []).append(i)
        self.epoch = 0

    def batch_size(self, bucket) -> int:
        b = self.spec.batch_size(bucket)
        return max(b // self.rows_per_example, 1)

    def __iter__(self) -> Iterator[Tuple[Tuple[int, int], List[int]]]:
        rng = np.random.RandomState(self.seed + self.epoch)
        self.epoch += 1
        batches, partial = [], []
        for bucket, idxs in self.buckets.items():
            idxs = list(idxs)
            if self.shuffle:
                rng.shuffle(idxs)
            bs = self.batch_size(bucket)
            for st in range(0, len(idxs), bs):
                chunk = idxs[st:st + bs]
                if len(chunk) < bs and self.drop_last:
                    partial.append((bucket, chunk))
                    continue
                batches.append((bucket, chunk))
        if not batches:
            # dataset smaller than one batch everywhere: keep the padded
            # partials — otherwise a looped loader would spin forever
            # yielding empty epochs
            batches = partial
        if self.shuffle:
            rng.shuffle(batches)
        if self.group > 1:
            batches = self._group_runs(batches, rng)
        return iter(batches)

    def _group_runs(self, batches, rng):
        """Reorder the epoch plan into contiguous runs of ``group``
        same-bucket batches. Gradient accumulation / steps_per_call stack
        ``group`` same-shape batches into one [group, B, ...] array; with
        contiguous runs the stacker never buffers across shapes, every
        stack boundary falls on a plan boundary, and a resume skip of
        N base batches is exact.

        Under drop_last a bucket's leftover partial run is CARRIED into
        the bucket's next epoch (prepended) rather than dropped —
        dropping would permanently exclude any bucket with fewer than
        ``group`` batches per epoch from training. When an epoch has no
        full run at all (tiny datasets) the partials are emitted so the
        loader still makes progress."""
        per: Dict[Tuple[int, int], List] = {}
        for b in batches:
            per.setdefault(b[0], []).append(b)
        if self.drop_last:
            for key, lst in getattr(self, "_carry", {}).items():
                per.setdefault(key, [])[:0] = lst
            self._carry = {}
        runs, partial = [], []
        for key, lst in per.items():
            for st in range(0, len(lst), self.group):
                run = lst[st:st + self.group]
                if len(run) == self.group:
                    runs.append(run)
                else:
                    partial.append((key, run))
        if not self.drop_last or not runs:
            runs += [r for _, r in partial]
        else:
            self._carry = {key: r for key, r in partial}
        if self.shuffle:
            rng.shuffle(runs)
        return [b for run in runs for b in run]

    def __len__(self):
        n = 0
        n_partial = 0
        per_bucket = []
        for bucket, idxs in self.buckets.items():
            bs = self.batch_size(bucket)
            full, rem = divmod(len(idxs), bs)
            cnt = full + (0 if (self.drop_last or rem == 0) else 1)
            per_bucket.append(cnt)
            n += cnt
            n_partial += int(rem > 0)
        if n == 0:
            return n_partial  # see __iter__: partials kept when all-partial
        if self.group > 1 and self.drop_last:
            g = sum((c // self.group) * self.group for c in per_bucket)
            return g if g else n  # no full run -> partial runs kept
        return n


class DistributedSampler:
    """Epoch-based per-shard sampler (reference data/sampler.py:64-121):
    pad indices to a multiple of shard_count, epoch-seeded shuffle, stride
    by shard. Kept as the reference-parity primitive for epoch-style
    sharding; the in-tree RE paths shard via the BucketLoader plan (train)
    and ReEvalDataset's strided split (eval) instead."""

    def __init__(self, n: int, shard_index: int = 0, shard_count: int = 1,
                 shuffle: bool = True, seed: int = 0):
        self.n = n
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        idxs = np.arange(self.n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idxs)
        pad = (-len(idxs)) % self.shard_count
        if pad:
            idxs = np.concatenate([idxs, idxs[:pad]])
        return iter(idxs[self.shard_index::self.shard_count].tolist())

    def __len__(self):
        return (self.n + self.shard_count - 1) // self.shard_count
