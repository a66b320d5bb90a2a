"""Loaders: bucketed batch iteration, task mixing, device prefetch.

  * ``BucketLoader`` — drives a dataset + StaticBucketSampler + per-task
    collate into fixed-shape numpy batches (the reference's
    DataLoader(collate_fn=...) role).
  * ``MetaLoader`` — pretraining task mixing (reference data/loader.py:17-84).
    The reference samples a task on rank 0 and ``any_broadcast``s it over
    NCCL every accumulation window (loader.py:43-47); here every host draws
    from the same seeded RNG stream, which is deterministic and needs no
    collective.
  * ``DevicePrefetcher`` — double-buffered device put on a worker thread;
    the port hands it a pinned, non-blocking torch copy
    (``training/infer.py``), replacing the reference's CUDA-stream
    PrefetchLoader (data/loader.py:87-142).
"""

from __future__ import annotations

import itertools
import os
import threading
import queue as queue_mod
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from uniter_tpu_torch.data.buckets import BucketSpec
from uniter_tpu_torch.data.sampler import StaticBucketSampler

# handoff slot for fork-based worker pools: set immediately before the
# Pool() fork so children capture the owning loader's (dataset, collate)
# (the ctypes store handles can't be pickled through initargs), cleared
# after. _FORK_LOCK serializes concurrent forks (e.g. an epoch re-fork on
# the prefetch thread racing another loader's construction) so children
# never capture another loader's state.
_FORK_STATE = None
_FORK_LOCK = threading.Lock()

_RNG_TLS = threading.local()


def _record_rng(seed) -> np.random.RandomState:
    """A RandomState seeded to ``seed`` — bit-identical stream to a fresh
    ``np.random.RandomState(seed)`` (``seed()`` reuses the same legacy
    MT19937 seeding) but ~75x cheaper: the constructor draws OS entropy for
    an interim SeedSequence and runs errstate-guarded re-seeding (~190us
    measured vs ~2.5us for re-seeding a cached instance), which at one
    RandomState per record was ~14-27% of total decode cost. One cached
    instance per thread (fork workers: per process); safe because every
    ``get_record`` consumes its stream entirely within the call — the
    documented per-record RNG contract — so no state leaks across records."""
    rs = getattr(_RNG_TLS, "rs", None)
    if rs is None:
        rs = _RNG_TLS.rs = np.random.RandomState(0)
    rs.seed(seed)
    return rs


def _fork_collate_shard(args):
    """Worker task: decode a CONTIGUOUS shard of the batch and collate it
    to exact size. Returning one collated dict per shard (a few large
    contiguous arrays) instead of per-record dicts keeps the pickle IPC at
    memcpy speed — measured 1-vCPU overhead of per-record returns was
    ~2.5ms/record, which would cap multi-core scaling at the parent."""
    idxs, seeds, t_b, r_b = args
    ds, collate = _FORK_STATE
    recs = [ds.get_record(i, _record_rng(s))
            for i, s in zip(idxs, seeds)]
    return collate(recs, t_b, r_b, len(recs))


def _assemble_shards(parts, bs, n_ex):
    """Concatenate worker-collated shards into the batch_size=``bs``
    batch (``n_ex`` real examples were collated). Each key's final length
    scales its actual rows by bs/n_ex — keys may carry any fixed
    rows-per-example ratio (NLVR2-paired input rows at 2x examples,
    targets at 1x). Training batches are always full (drop_last), so
    padding only triggers on eval tails."""
    out = {}
    for k, v0 in parts[0].items():
        if isinstance(v0, np.ndarray) and v0.ndim >= 1:
            n_k = sum(p[k].shape[0] for p in parts)
            want = max(n_k * bs // n_ex, n_k) if n_ex else n_k
            full = np.zeros((want,) + v0.shape[1:], v0.dtype)
            ofs = 0
            for p in parts:
                full[ofs:ofs + p[k].shape[0]] = p[k]
                ofs += p[k].shape[0]
            out[k] = full
        elif isinstance(v0, list):
            out[k] = [x for p in parts for x in p[k]]
        else:
            out[k] = v0
    return out


_CHILD_SHM = {}  # name -> mmap, cached per worker process


def _attach_shm(name):
    """Map a parent-created shared-memory segment in a worker via its
    /dev/shm file directly — multiprocessing.SharedMemory(name=...) would
    enroll the attachment in the resource tracker (3.12 behavior), whose
    unlink bookkeeping then races the parent's at pool teardown."""
    m = _CHILD_SHM.get(name)
    if m is None:
        import mmap

        with open("/dev/shm/" + name.lstrip("/"), "r+b") as f:
            m = mmap.mmap(f.fileno(), 0)
        _CHILD_SHM[name] = m
    return m


def _fork_collate_into_shm(args):
    """Worker task for worker_type='shm': decode + collate a contiguous
    shard, then write each array straight into its slice of the parent's
    shared-memory segment. Only non-array collate outputs travel back
    through pickle (tiny). The layout carries (shape, dtype, byte offset,
    rows-per-example inverse ratio) per key."""
    name, layout, a, idxs, seeds, t_b, r_b = args
    ds, collate = _FORK_STATE
    recs = [ds.get_record(i, _record_rng(s))
            for i, s in zip(idxs, seeds)]
    part = collate(recs, t_b, r_b, len(recs))
    shm = _attach_shm(name)
    extras = {}
    for k, v in part.items():
        spec = layout.get(k)
        if spec is None or not isinstance(v, np.ndarray):
            extras[k] = v
            continue
        shape, dtype, offset, r_inv = spec
        arr = np.ndarray(shape, dtype, buffer=shm, offset=offset)
        lo = a // r_inv
        arr[lo:lo + v.shape[0]] = v
    return extras


class _ShmRing:
    """Per-bucket-shape ring of shared-memory segments holding whole
    collated batches. A segment is reused after ``depth`` newer batches —
    consumers (device_put / DevicePrefetcher at depth 2) are done with the
    host arrays well before that."""

    def __init__(self, depth: int = 4):
        self.depth = depth
        self.segs: Dict[Any, list] = {}
        self.idx: Dict[Any, int] = {}
        self.layouts: Dict[Any, dict] = {}
        self.rho: Dict[Any, int] = {}  # rows per example (paired: 2)

    def layout_from_template(self, key, batch, n_examples):
        """Record key -> (shape, dtype, offset, r_inv) and size the ring's
        segments from a serially-collated template batch. r_inv is the
        key's rows divisor relative to the batch's max row count (NLVR2
        paired: input rows at r_inv=1, per-pair targets at r_inv=2)."""
        from multiprocessing import shared_memory

        n_rows = max((v.shape[0] for v in batch.values()
                      if isinstance(v, np.ndarray) and v.ndim >= 1),
                     default=0)
        if not n_rows or n_rows % max(n_examples, 1):
            self.layouts[key] = {}
            return {}
        self.rho[key] = n_rows // n_examples
        layout, offset = {}, 0
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0]:
                r_inv = max(n_rows // v.shape[0], 1)
                if v.shape[0] * r_inv != n_rows:
                    continue  # rows not example-proportional: pickle it
                offset = (offset + 127) & ~127  # cacheline-align slices
                layout[k] = (v.shape, v.dtype, offset, r_inv)
                offset += v.nbytes
        self.layouts[key] = layout
        self.segs[key] = [shared_memory.SharedMemory(create=True,
                                                     size=max(offset, 1))
                          for _ in range(self.depth)]
        self.idx[key] = 0
        return layout

    def next_segment(self, key):
        segs = self.segs[key]
        self.idx[key] = (self.idx[key] + 1) % len(segs)
        return segs[self.idx[key]]

    def close(self):
        for segs in self.segs.values():
            for s in segs:
                try:
                    s.close()
                except Exception:
                    # live numpy views raise BufferError on close; the
                    # segment must STILL be unlinked or /dev/shm leaks a
                    # whole batch per segment for the process lifetime
                    pass
                try:
                    s.unlink()
                except Exception:
                    pass
        self.segs.clear()


class BucketLoader:
    """Yields fixed-shape numpy batches forever (train) or for one pass
    (eval).

    Multi-host contract (``shard_index``/``shard_count``): the sampler runs
    over the FULL dataset with the same seed on every host, so all hosts
    follow an identical global batch plan (bucket sequence and batch sizes
    in lockstep — required for SPMD training over a global mesh, where
    per-host plans would dispatch mismatched programs). Each host then
    materializes only its contiguous block of every batch (1/P of the rows,
    matching the data-axis device order) and yields that LOCAL batch;
    ``training.loop.device_put_batch`` assembles the global array from the
    per-process blocks. The reference sharded ids in the dataset layer
    (data/data.py:218-225), which is only safe when ranks may run different
    shapes (torch DDP); under jit lockstep the plan itself must be shared.
    """

    def __init__(
        self,
        dataset,
        spec: BucketSpec,
        collate: Optional[Callable] = None,
        *,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: Optional[bool] = None,
        loop: bool = False,
        num_workers: int = 0,
        worker_type: Optional[str] = None,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        self.dataset = dataset
        self.spec = spec
        self.collate = collate or type(dataset).collate
        self.seed = seed
        self.loop = loop
        self.num_workers = num_workers
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._pool = None
        self._proc_pool = None
        # "thread": ThreadPoolExecutor — decode's heavy pieces (lmdbx mmap
        # reads, lz4 frames, large numpy ops) release the GIL, so threads
        # scale on multi-core hosts with near-zero IPC cost. "process":
        # fork-based pool for GIL-bound decode mixes — children inherit the
        # read-only store mmaps (fork-safe: native/lmdbx.cc maps PROT_READ,
        # no shared mutable state); each worker decodes AND collates a
        # contiguous batch shard, returned pickled. "shm": process pool
        # whose workers collate straight into a shared-memory ring — zero
        # parent-side copies (the batch bytes are ~50MB at fine-tune
        # shapes, so pickle IPC is the cap the torch DataLoader's shm
        # design avoids). All modes are deterministic: the per-record RNG
        # seeds are drawn in the parent (see _fetch/_make_batch).
        worker_type = worker_type or os.environ.get(
            "UNITER_WORKER_TYPE", "thread")
        if worker_type not in ("thread", "process", "shm"):
            raise ValueError(f"worker_type {worker_type!r}")
        self.worker_type = worker_type
        self._shm_ring = None
        if num_workers > 0 and worker_type == "thread":
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(num_workers)
        elif num_workers > 0:
            self._fork_pool()
            if worker_type == "shm":
                self._shm_ring = _ShmRing()
        rows = getattr(dataset, "rows_per_example", 1)
        sizes = [dataset.size_of(i) for i in range(len(dataset))]
        self.sampler = StaticBucketSampler(
            sizes, spec, shuffle=shuffle, seed=seed,
            drop_last=loop if drop_last is None else drop_last,
            rows_per_example=rows,
        )
        self._epoch = 0
        self._skip = 0  # pending resume fast-forward (see skip_batches)

    def _fork_pool(self):
        """(Re)create the fork worker pool capturing the CURRENT dataset
        state. Fork now so the children inherit this loader's dataset +
        collate via the module global (initargs would have to pickle the
        ctypes store handles); Pool() forks its workers eagerly. Called
        again after every dataset.new_epoch() — epoch resampling (ITM
        negatives, RE shuffles) mutates the parent's dataset, which the
        already-forked children would never see."""
        import multiprocessing as mp

        global _FORK_STATE
        if self._proc_pool is not None:
            self._proc_pool.terminate()
            self._proc_pool.join()
        with _FORK_LOCK:
            _FORK_STATE = (self.dataset, self.collate)
            self._proc_pool = mp.get_context("fork").Pool(self.num_workers)
            _FORK_STATE = None

    def close(self):
        if self._proc_pool is not None:
            self._proc_pool.terminate()
            self._proc_pool.join()
            self._proc_pool = None
        if self._shm_ring is not None:
            self._shm_ring.close()
            self._shm_ring = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):  # worker processes must not outlive the loader
        try:
            self.close()
        except Exception:
            pass

    def set_group(self, group: int):
        """Emit same-bucket batches in contiguous runs of ``group`` (see
        StaticBucketSampler._group_runs). AccumLoader calls this so stacked
        accumulation batches are plan-contiguous and resume skips land
        exactly on stack boundaries."""
        self.sampler.group = max(int(group), 1)

    def _fetch(self, idxs, seeds):
        # per-record RNG streams: one seed draw per record of the global
        # batch from the loader stream (drawn in _iter_once), each record
        # masked/sampled from its own RandomState. This makes results
        # identical across num_workers settings (and worker types) and
        # process counts, AND lets skip_batches() fast-forward the stream
        # without fetching (the draw count per batch is just the batch's
        # record count, not data-dependent).
        if self._pool is not None:
            return list(self._pool.map(
                lambda iv: self.dataset.get_record(iv[0], _record_rng(iv[1])),
                zip(idxs, seeds)))
        return [self.dataset.get_record(i, _record_rng(s))
                for i, s in zip(idxs, seeds)]

    def _make_batch(self, idxs, seeds, t_b, r_b, bs):
        if self._proc_pool is not None:
            if self._shm_ring is not None:
                return self._make_batch_shm(idxs, seeds, t_b, r_b, bs)
            if len(idxs) != bs:
                # partial (eval-tail) batch: the serial collate owns the
                # padding-row semantics (position_ids arange, -1 labels);
                # zero-padding shards here would diverge from serial
                return self.collate(
                    [self.dataset.get_record(i, _record_rng(s))
                     for i, s in zip(idxs, seeds)], t_b, r_b, bs)
            w = min(self.num_workers, max(len(idxs) // 8, 1))
            bounds = np.linspace(0, len(idxs), w + 1).astype(int)
            tasks = [(list(idxs[a:b]), seeds[a:b], t_b, r_b)
                     for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
            parts = self._proc_pool.map(_fork_collate_shard, tasks)
            return _assemble_shards(parts, bs, len(idxs))
        return self.collate(self._fetch(idxs, seeds), t_b, r_b, bs)

    def _make_batch_shm(self, idxs, seeds, t_b, r_b, bs):
        """Zero-copy assembly: workers collate contiguous shards directly
        into a shared-memory segment; the yielded arrays VIEW that segment
        (valid for the ring depth — consumers transfer/copy well within
        it). First batch of a bucket shape runs serially to establish the
        layout; partial (eval-tail) batches fall back to serial."""
        import math

        key = (t_b, r_b, bs)
        layout = self._shm_ring.layouts.get(key)
        if layout is None or len(idxs) != bs:
            recs = [self.dataset.get_record(i, _record_rng(s))
                    for i, s in zip(idxs, seeds)]
            batch = self.collate(recs, t_b, r_b, bs)
            if layout is None and len(idxs) == bs:
                self._shm_ring.layout_from_template(key, batch, bs)
            return batch
        if not layout:  # template had no example-proportional rows
            recs = [self.dataset.get_record(i, _record_rng(s))
                    for i, s in zip(idxs, seeds)]
            return self.collate(recs, t_b, r_b, bs)
        seg = self._shm_ring.next_segment(key)
        rho = self._shm_ring.rho[key]
        align_r = 1  # row alignment every key's r_inv divides
        for (_, _, _, r_inv) in layout.values():
            align_r = align_r * r_inv // math.gcd(align_r, r_inv)
        align_e = align_r // math.gcd(align_r, rho)  # in example units
        if bs % align_e:
            recs = [self.dataset.get_record(i, _record_rng(s))
                    for i, s in zip(idxs, seeds)]
            return self.collate(recs, t_b, r_b, bs)
        n_units = bs // align_e
        w = min(self.num_workers, max(n_units, 1))
        bounds = np.linspace(0, n_units, w + 1).astype(int) * align_e
        tasks = [(seg.name, layout, int(a) * rho, list(idxs[a:b]),
                  seeds[a:b], t_b, r_b)
                 for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        extras_parts = self._proc_pool.map(_fork_collate_into_shm, tasks)
        batch = {k: np.ndarray(shape, dtype, buffer=seg.buf, offset=off)
                 for k, (shape, dtype, off, _) in layout.items()}
        for k, v0 in extras_parts[0].items():
            if isinstance(v0, list):
                batch[k] = [x for p in extras_parts for x in p[k]]
            elif isinstance(v0, np.ndarray):
                batch[k] = np.concatenate([p[k] for p in extras_parts])
            else:
                batch[k] = v0
        return batch

    def skip_batches(self, n: int):
        """Resume fast-forward: advance the loader as if ``n`` batches had
        already been consumed — same plan position, same per-record RNG
        stream — without fetching a single record. Called by the training
        loops when restoring a checkpoint mid-epoch, so a resumed run
        continues on the batches the interrupted run never saw instead of
        silently replaying from batch 0."""
        self._skip += int(n)

    def _iter_once(self) -> Iterator[Dict[str, Any]]:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + self._epoch) % (2**31))
        if self.loop:
            # epoch progression is a TRAINING concept. An eval loader
            # (loop=False) replays the identical pass every time it is
            # re-iterated: same per-record RNG, no dataset new_epoch()
            # resample, no plan reshuffle — validation metrics stay
            # comparable across rounds (the reference validates on fixed
            # pairings).
            self._epoch += 1
            new_epoch = getattr(self.dataset, "new_epoch", None)
            if new_epoch is not None and self._epoch > 1:
                new_epoch(rng)
                if self._proc_pool is not None:
                    # forked children hold the PRE-resample dataset
                    self._fork_pool()
                # NOTE: grouped partial-run carry dies with the old
                # sampler here — the resample invalidates the carried
                # batches' indices and bucket keys; next epoch re-plans
                # those examples anyway.
                self.sampler = StaticBucketSampler(
                    [self.dataset.size_of(i)
                     for i in range(len(self.dataset))],
                    self.spec, shuffle=self.sampler.shuffle,
                    seed=self.seed + self._epoch,
                    drop_last=self.sampler.drop_last,
                    rows_per_example=self.sampler.rows_per_example,
                    group=self.sampler.group,
                )
        p, n_shards = self.shard_index, self.shard_count
        for (t_b, r_b), idxs in self.sampler:
            bs = self.sampler.batch_size((t_b, r_b))
            if self._skip > 0:
                # resume fast-forward: burn this batch's RNG draws (one per
                # record, as below) and move on without fetching
                self._skip -= 1
                rng.randint(2**31, size=len(idxs))
                continue
            # one seed per record of the GLOBAL batch, so a record draws
            # the same masks whatever the process count
            seeds = rng.randint(2**31, size=len(idxs)).tolist()
            if n_shards == 1:
                my, local_bs = idxs, bs
            else:
                # this host's contiguous block of the global batch
                assert bs % n_shards == 0, (bs, n_shards)
                local_bs = bs // n_shards
                my = idxs[p * local_bs:(p + 1) * local_bs]
                seeds = seeds[p * local_bs:(p + 1) * local_bs]
                if not my and self.loop:
                    raise ValueError(
                        f"dataset too small for {n_shards}-process training: "
                        f"batch of {len(idxs)} examples leaves shard {p} "
                        "empty")
                if not my:
                    continue  # eval tail handled by this host's peers
            yield self._make_batch(my, seeds, t_b, r_b, local_bs)

    def __iter__(self):
        if not self.loop:
            return self._iter_once()
        return itertools.chain.from_iterable(
            self._iter_once() for _ in itertools.count())

    def __len__(self):
        return len(self.sampler)

    def example_batches(self):
        """One collated batch per bucket shape (for ahead-of-time compile
        warmup: every (T, R) bucket is a distinct XLA program)."""
        rng = np.random.RandomState(self.seed)
        out = []
        for bucket, idxs in self.sampler.buckets.items():
            bs = self.sampler.batch_size(bucket)
            if self.shard_count > 1:
                bs //= self.shard_count
            rec = self.dataset.get_record(idxs[0], rng)
            out.append(self.collate([rec], bucket[0], bucket[1], bs))
        return out


class AccumLoader:
    """Group ``accum`` same-shape batches into one stacked [accum, ...]
    batch for scan-based gradient accumulation (training/step.py). Batches
    are buffered per bucket shape so stacking never mixes shapes."""

    def __init__(self, it, accum: int):
        self.base = it
        if accum > 1 and hasattr(it, "set_group"):
            # contiguous same-bucket runs in the plan: stacking becomes a
            # pure sequential grouping (no cross-shape buffering) and
            # resume skips are exact at any bucket-grid size
            it.set_group(accum)
        self.it = iter(it)
        self.accum = accum
        # shm batches VIEW ring segments reused after ring-depth newer
        # batches; buffering `accum` of them live (accum/steps_per_call
        # can exceed the depth) would read overwritten memory — copy at
        # intake instead (still one copy, at np.stack's own cost point)
        self._copy = (getattr(it, "worker_type", None) == "shm"
                      and getattr(it, "num_workers", 0) > 0)

    def skip_batches(self, n: int):
        """Resume fast-forward: n stacked batches = n * accum base batches
        (exact: the base plan is grouped into accum-runs, see __init__)."""
        if hasattr(self.base, "skip_batches"):
            self.base.skip_batches(n * self.accum)

    def __iter__(self):
        if self.accum == 1:
            yield from self.it
            return
        buffers: Dict[tuple, list] = {}
        for batch in self.it:
            if self._copy:
                batch = {k: (np.array(v) if isinstance(v, np.ndarray)
                             else v) for k, v in batch.items()}
            key = tuple(
                (k, v.shape) for k, v in sorted(batch.items())
                if isinstance(v, np.ndarray))
            buf = buffers.setdefault(key, [])
            buf.append(batch)
            if len(buf) == self.accum:
                stacked = {
                    k: np.stack([b[k] for b in buf])
                    for k, v in buf[0].items() if isinstance(v, np.ndarray)
                }
                buffers[key] = []
                yield stacked


class MetaLoader:
    """Infinite mixed-task iterator: draw task ~ mix_ratio each accumulation
    window, then yield accum_steps batches of it (reference
    data/loader.py:17-57)."""

    def __init__(self, loaders: Dict[str, tuple], accum_steps: int = 1,
                 seed: int = 42):
        # loaders: name -> (loader, ratio)
        self.names = []
        self.iters = {}
        self.loaders = {}
        for name, (loader, ratio) in loaders.items():
            self.loaders[name] = loader
            self.iters[name] = iter(loader)
            self.names.extend([name] * int(ratio))
        self.accum_steps = accum_steps
        self.rng = np.random.RandomState(seed)
        self._pending = None  # (task, remaining) partial window after skip

    def skip_steps(self, n: int):
        """Resume fast-forward: replay n task draws from the shared seeded
        stream (every host replays identically — the lockstep property the
        MetaLoader design rests on) and fast-forward each task's loader by
        the number of batches it would have served. A partially consumed
        accumulation window is carried over so the next yields finish it."""
        counts: Dict[str, int] = {}
        rem = int(n)
        while rem > 0:
            task = self.names[self.rng.randint(len(self.names))]
            take = min(self.accum_steps, rem)
            counts[task] = counts.get(task, 0) + take
            if take < self.accum_steps:
                self._pending = (task, self.accum_steps - take)
            rem -= take
        for name, c in counts.items():
            loader = self.loaders[name]
            if hasattr(loader, "skip_batches"):
                loader.skip_batches(c)

    def _next_from(self, task):
        # A resume skip can burn whole epochs of a non-looping loader, so
        # several back-to-back recreations may be needed before a batch
        # appears; a bare next() after one refill would raise StopIteration
        # inside the generator frame (PEP 479 -> RuntimeError).
        for _ in range(100_000):
            try:
                return next(self.iters[task])
            except StopIteration:
                self.iters[task] = iter(self.loaders[task])
        raise ValueError(f"task {task!r}: loader yields no batches")

    def __iter__(self):
        while True:
            if self._pending is not None:
                task, k = self._pending
                self._pending = None
            else:
                task = self.names[self.rng.randint(len(self.names))]
                k = self.accum_steps
            for _ in range(k):
                yield task, self._next_from(task)


class DevicePrefetcher:
    """Host->device transfer overlap: a worker thread device_puts the next
    batch (with the given shardings) while the current one computes."""

    def __init__(self, it: Iterator, device_put: Callable, depth: int = 2):
        self.it = it
        self.device_put = device_put
        self.q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._stop = False
        self.thread = threading.Thread(target=self._work, daemon=True,
                                       name="prefetch")
        self.thread.start()

    def _work(self):
        from uniter_tpu_torch.utils import trace

        try:
            for item in self.it:
                if self._stop:
                    return
                with trace.span("prefetch.put"):
                    out = self.device_put(item)
                self.q.put(out)
                if self._stop:
                    return
        except Exception as e:  # surface in consumer
            self.q.put(e)
        self.q.put(StopIteration)

    def close(self):
        """Stop the worker and drop its buffered batches. The loops break
        out of infinite loaders after num_train_steps; without this the
        worker stays blocked in q.put holding `depth` device-resident
        batches in HBM for the rest of the process."""
        self._stop = True
        while self.thread.is_alive():
            try:
                self.q.get_nowait()  # free a slot so a blocked put returns
            except queue_mod.Empty:
                pass
            self.thread.join(timeout=0.05)
        while True:  # release any remaining device buffers
            try:
                self.q.get_nowait()
            except queue_mod.Empty:
                break

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is StopIteration:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item
