"""Shared inference plumbing (counterpart of ``uniter_tpu/training/infer.py``):
reload ``hps.json``/``model.json`` from a training directory, load a
weights snapshot (the JAX package's ``model_step_N.msgpack`` or this
package's ``model_step_N.pt``), and run a model over bucketed eval batches
on one device.

Parameters go to the device once (the caller moves the model); each batch
is copied host -> device by a pinned, non-blocking put on the
``DevicePrefetcher`` thread while the previous batch computes. One process
drives one device. Over several processes each rank runs its block of
every batch of the shared plan (the loader's ``shard_index`` /
``shard_count``, ``driver.shard_kw``) and ``gather_batches`` puts every
rank's results back in the order one process gives them.
"""

from __future__ import annotations

import json
import os
import re
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from uniter_tpu_torch.config import UniterConfig, resolve_kernel_policies
from uniter_tpu_torch.models.checkpoint import (
    load_torch_checkpoint, state_dict_from_jax_params)
from uniter_tpu_torch.utils.logger import LOGGER
from uniter_tpu_torch.utils.save import load_params_msgpack


def load_train_meta(train_dir: str):
    """(hps Namespace, model-config dict) from a training output dir
    (reference inf_nlvr2.py:28,63-71)."""
    with open(os.path.join(train_dir, "log", "hps.json")) as f:
        hps = SimpleNamespace(**json.load(f))
    with open(os.path.join(train_dir, "log", "model.json")) as f:
        model_json = json.load(f)
    return hps, model_json


def model_config_from_meta(model_json: dict, device, **overrides) -> UniterConfig:
    """Training metadata stores the policies a run RESOLVED on its own
    backend (``attention_impl="pallas"`` from a TPU run): re-resolve them
    for ``device``."""
    return resolve_kernel_policies(
        UniterConfig.from_dict(model_json, **overrides), device)


_SNAPSHOT = re.compile(r"model_step_(\d+)\.(pt|msgpack)")
# at one step, this package's own .pt before a JAX export
_EXT_RANK = {"pt": 1, "msgpack": 0}


def _snapshots(d: str):
    """(step, ext rank, file) of every weights snapshot in ``d``."""
    out = []
    for f in os.listdir(d):
        m = _SNAPSHOT.fullmatch(f)
        if m:
            out.append((int(m.group(1)), _EXT_RANK[m.group(2)], f))
    return out


def resolve_ckpt(train_dir: str, ckpt: Optional[str] = None) -> str:
    """An explicit snapshot file, ``best``/``<step>`` by name under
    train_dir/ckpt (the reference's ``--checkpoint best`` convention,
    inf_re.py:53-56), or the latest model_step_N snapshot: ``.msgpack``
    (a JAX run) or ``.pt``  (a run of this package), the newer step first
    and, at one step, the ``.pt``.

    An explicitly requested checkpoint that does not exist is an error:
    falling back to the latest snapshot would report results for the wrong
    weights."""
    if ckpt:
        if not os.path.exists(ckpt) and (ckpt == "best" or ckpt.isdigit()):
            if not train_dir:
                raise FileNotFoundError(
                    f"--ckpt {ckpt} needs --train_dir to resolve")
            d = os.path.join(train_dir, "ckpt")
            named = sorted((_EXT_RANK[e], f"model_step_{ckpt}.{e}")
                           for e in _EXT_RANK
                           if os.path.exists(os.path.join(
                               d, f"model_step_{ckpt}.{e}")))
            ckpt = os.path.join(d, named[-1][1] if named
                                else f"model_step_{ckpt}.msgpack")
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"--ckpt {ckpt} does not exist")
        return ckpt
    if not train_dir:
        raise FileNotFoundError("no --train_dir and no --ckpt given")
    d = os.path.join(train_dir, "ckpt")
    cands = _snapshots(d)
    if not cands:
        raise FileNotFoundError(f"no weight snapshot under {d}")
    path = os.path.join(d, max(cands)[2])
    LOGGER.info("using checkpoint %s", path)
    return path


_TRUNK = ("embeddings.", "img_embeddings.", "encoder.", "pooler.")


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A weights snapshot as this package's state dict (CPU tensors): a JAX
    ``.msgpack`` through the weight bridge, or a ``.pt`` in the reference
    key layout (this package's own, or a released one with gamma/beta
    names), normalized and with its trunk under ``uniter.``."""
    if path.endswith(".msgpack"):
        sd = state_dict_from_jax_params(load_params_msgpack(path))
    elif path.endswith(".pt"):
        sd = {(f"uniter.{k}" if k.startswith(_TRUNK) else k): v
              for k, v in load_torch_checkpoint(path).items()}
    else:
        raise ValueError(f"unknown checkpoint format: {path}")
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def to_device(batch: dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's numpy arrays (or host tensors) as tensors on ``device``:
    pinned host memory and a non-blocking copy on a CUDA device. Other
    entries (question ids) are left out."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            t = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
    return out


def eval_batches(predict_fn, loader, device, prefetch: int = 2,
                 group: int = 1):
    """Drive ``predict_fn`` (device batch -> outputs) over an eval loader,
    with the NEXT batch's host collate and transfer overlapped with the
    current predict (``DevicePrefetcher``). Yields
    ``(host_batch, device_outputs)``; rows past the real row count are
    the collate's padding rows (a batch's rows: its ``attn_mask``'s, or
    without one its ``input_ids``'). Each predict is the root span
    ``infer.batch`` (``utils.trace``), the batch's index its request.
    ``group`` rows form one example (NLVR2's
    paired models read rows (2i, 2i+1) as a pair, ``inf_nlvr2.py:65-67``):
    the batch goes to the device whole, so the groups stay intact, and a
    batch whose row count ``group`` does not divide raises."""
    from uniter_tpu_torch.data.loader import DevicePrefetcher

    from uniter_tpu_torch.utils import trace

    device = torch.device(device)
    it = DevicePrefetcher(iter(loader), lambda b: (b, to_device(b, device)),
                          depth=prefetch)
    try:
        for index, (batch, db) in enumerate(it):
            rows = db["attn_mask" if "attn_mask" in db
                      else "input_ids"].shape[0]
            if rows % group:
                raise ValueError(f"{rows} rows do not form groups of {group}")
            with trace.span("infer.batch", request=index), \
                    torch.inference_mode():
                out = predict_fn(db)
            yield batch, out
    finally:
        it.close()


def gather_batches(loader, per_batch: list) -> list:
    """Every rank's results, in the order one process would have produced
    them: ``per_batch`` holds this rank's results a batch, one list for
    each batch it ran of ``loader`` (a ``BucketLoader`` sharded over the
    processes); the loader's plan says which ranks ran a block of which
    batch, and each batch's blocks go in rank order. Every rank calls it
    and gets the whole list. One process: the lists joined."""
    from uniter_tpu_torch.parallel.collectives import (
        all_gather_list, data_group, data_size)

    if data_size() == 1:
        return [r for part in per_batch for r in part]
    parts = [iter(p) for p in all_gather_list(per_batch, data_group())]
    n = len(parts)
    sampler = loader.sampler
    epoch = sampler.epoch  # walking the plan again must not advance it
    out = []
    for bucket, idxs in sampler:
        local = sampler.batch_size(bucket) // n
        for p in range(n):
            if idxs[p * local:(p + 1) * local]:
                out.extend(next(parts[p]))
    sampler.epoch = epoch
    return out


def gather_sums(*values):
    """Each value summed over the data axis (host numbers: evaluation
    counters); the values themselves in one process."""
    from uniter_tpu_torch.parallel.collectives import (
        all_gather_list, data_group)

    parts = all_gather_list(values, data_group())
    return tuple(sum(p[i] for p in parts) for i in range(len(values)))
