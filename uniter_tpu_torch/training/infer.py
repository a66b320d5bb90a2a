"""Shared inference plumbing (counterpart of ``uniter_tpu/training/infer.py``):
reload ``hps.json``/``model.json`` from a training directory, load a
weights snapshot, and run a model over bucketed eval batches on one
device.

Parameters go to the device once (the caller moves the model); each batch
is copied host -> device by a pinned, non-blocking put on the
``DevicePrefetcher`` thread while the previous batch computes. One process
drives one device, so there is no mesh and no zero-row padding.
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
from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
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


def resolve_ckpt(train_dir: str, ckpt: Optional[str] = None) -> str:
    """An explicit snapshot file, ``best``/``<step>`` by name under
    train_dir/ckpt (the reference's ``--checkpoint best`` convention,
    inf_re.py:53-56), or the latest model_step_N.msgpack.

    An explicitly requested checkpoint that does not exist is an error:
    falling back to the latest snapshot would report results for the wrong
    weights."""
    if ckpt:
        if not os.path.exists(ckpt) and (ckpt == "best" or ckpt.isdigit()):
            if not train_dir:
                raise FileNotFoundError(
                    f"--ckpt {ckpt} needs --train_dir to resolve")
            ckpt = os.path.join(train_dir, "ckpt",
                                f"model_step_{ckpt}.msgpack")
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"--ckpt {ckpt} does not exist")
        return ckpt
    if not train_dir:
        raise FileNotFoundError("no --train_dir and no --ckpt given")
    d = os.path.join(train_dir, "ckpt")
    cands = []
    for f in os.listdir(d):
        m = re.match(r"model_step_(\d+)\.msgpack", f)
        if m:
            cands.append((int(m.group(1)), f))
    if not cands:
        raise FileNotFoundError(f"no weight snapshot under {d}")
    path = os.path.join(d, max(cands)[1])
    LOGGER.info("using checkpoint %s", path)
    return path


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A JAX weights snapshot as this package's state dict (CPU tensors)."""
    if path.endswith(".msgpack"):
        sd = state_dict_from_jax_params(load_params_msgpack(path))
        return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}
    if path.endswith(".pt"):
        raise ValueError(
            "torch checkpoints load through models.checkpoint."
            "load_torch_checkpoint, not here")
    raise ValueError(f"unknown checkpoint format: {path}")


def to_device(batch: dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's numpy arrays as tensors on ``device``: pinned host
    memory and a non-blocking copy on a CUDA device."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
    return out


def eval_batches(predict_fn, loader, device, prefetch: int = 2):
    """Drive ``predict_fn`` (device batch -> outputs) over an eval loader,
    with the NEXT batch's host collate and transfer overlapped with the
    current predict (``DevicePrefetcher``). Yields
    ``(host_batch, device_outputs)``; rows past the real row count are
    the collate's padding rows."""
    from uniter_tpu_torch.data.loader import DevicePrefetcher

    device = torch.device(device)
    it = DevicePrefetcher(iter(loader), lambda b: (b, to_device(b, device)),
                          depth=prefetch)
    try:
        for batch, db in it:
            with torch.inference_mode():
                out = predict_fn(db)
            yield batch, out
    finally:
        it.close()
