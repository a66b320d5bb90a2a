"""Checkpoints and run provenance (counterpart of
``uniter_tpu/utils/save.py``, reference utils/save.py).

``save_training_meta`` writes ``log/hps.json``, ``log/model.json`` and
``log/git_info.json``. ``TrainStateSaver`` writes, at every save, the
weights as ``ckpt/model_step_N.pt`` (a torch state dict in the reference
``.pt`` key layout, what ``inf_vqa`` and the reference load) and the rest of
the train state as ``ckpt/train_state_N.pt`` (step, AdamW moments by
parameter name, update count, gradient norm, the run's dropout seed), and
restores the latest pair. A save that improves a validation metric also
writes ``ckpt/model_step_best.pt`` and its sidecar ``model_step_best.json``
(``{"step", "value"}``). The JAX package keeps its train state with
Orbax; the port uses ``torch.save`` only. In master-weight mode the
weights written are the optimizer's fp32 masters, and a restore sets the
masters from them (JAX ``utils/save.py:103-125``).

``save(..., block=False)`` (JAX ``utils/save.py:58-100``) copies every
tensor to the host before it returns, since the optimizer updates the
parameters and moments in place, and leaves only the disk writes (each
``.tmp`` then ``os.replace``, the best export included) to a thread.
``restore``, ``latest_step``, ``best_info``, ``clear_best`` and the next
``save`` wait for it; ``wait`` raises what the write raised.

Over several processes every rank calls ``save`` (the optimizer gathers
its sharded state by parameter name, a collective) and rank 0 alone
writes, removes and clears (JAX ``utils/save.py:91,148``); every rank
restores from the same files, whatever the world size that wrote them.

Weights-only snapshots written by the JAX package
(``ckpt/model_step_N.msgpack``, flax ``serialization.to_bytes``) are read
with ``msgpack`` and numpy alone.

flax's format: a msgpack map of nested string-keyed maps whose leaves are
ext type 1 (ndarray: a msgpack tuple of shape, dtype name and C-order
bytes) or ext type 3 (numpy scalar, same payload). Arrays above 2**30
bytes are split into ``__msgpack_chunked_array__`` maps.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import threading
from typing import Any, Dict, Optional

import numpy as np

from uniter_tpu_torch.utils.logger import LOGGER

_NDARRAY, _NPSCALAR = 1, 3


def _ndarray(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":
        raise TypeError("bfloat16 arrays in a snapshot are not supported; "
                        "the JAX package exports fp32 weights")
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)


def _ext_hook(code, data):
    if code == _NDARRAY:
        return _ndarray(data)
    if code == _NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"not a weights snapshot: msgpack ext type {code}")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_params_msgpack(path: str) -> Dict[str, Any]:
    """The parameter tree of a flax msgpack snapshot, as nested dicts of
    numpy arrays (the input of ``models.checkpoint.state_dict_from_jax_params``)."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)


def save_training_meta(output_dir: str, args: Any, model_config: dict):
    os.makedirs(os.path.join(output_dir, "log"), exist_ok=True)
    os.makedirs(os.path.join(output_dir, "ckpt"), exist_ok=True)
    hps = {k: v for k, v in sorted(vars(args).items())
           if not k.startswith("_")}
    with open(os.path.join(output_dir, "log", "hps.json"), "w") as f:
        json.dump(hps, f, indent=4, default=str)
    with open(os.path.join(output_dir, "log", "model.json"), "w") as f:
        json.dump(model_config, f, indent=4)
    try:
        sha = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], text=True,
            stderr=subprocess.DEVNULL).strip()
        branch = subprocess.check_output(
            ["git", "rev-parse", "--abbrev-ref", "HEAD"], text=True,
            stderr=subprocess.DEVNULL).strip()
        with open(os.path.join(output_dir, "log", "git_info.json"), "w") as f:
            json.dump({"branch": branch, "commit": sha}, f, indent=4)
    except Exception:
        LOGGER.info("git info not available")


def _host(t):
    return t.detach().to("cpu", copy=True)


class TrainStateSaver:
    """``ckpt/model_step_N.pt`` + ``ckpt/train_state_N.pt`` per save; the
    newest ``max_to_keep`` train states are kept (every weights file is,
    as the JAX package keeps every export)."""

    def __init__(self, output_dir: str, max_to_keep: int = 3):
        self.dir = os.path.abspath(os.path.join(output_dir, "ckpt"))
        os.makedirs(self.dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._thread = None
        self._error = None

    def wait(self):
        """Block until the pending asynchronous write is on disk; raise
        what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _steps(self):
        return sorted(int(m.group(1)) for f in os.listdir(self.dir)
                      for m in [re.fullmatch(r"train_state_(\d+)\.pt", f)]
                      if m)

    def save(self, step: int, state, seed: int = 0,
             best_value: Optional[float] = None, block: bool = True):
        """Write the weights and the train state of ``step``. With
        ``best_value`` the same host copy of the weights is also written
        as ``model_step_best.pt``, with the sidecar
        ``model_step_best.json`` ``{"step", "value"}`` (the reference's
        ``model_saver.save(model, 'best')``, train_re.py:259-263). With
        ``block=False`` the host copy is complete when this returns and
        the files are written by a thread (module docstring)."""
        from uniter_tpu_torch.parallel.collectives import process_index

        self.wait()
        sd = state.model.state_dict()
        sd.update(state.opt.masters())
        opt = state.opt.state()
        if process_index() > 0:
            return  # the gathers above are all a rank past 0 takes part in
        weights = {k: _host(v) for k, v in sd.items()}
        rest = {"step": int(step), "seed": int(seed),
                "count": opt["count"], "gnorm": _host(opt["gnorm"]),
                "mu": {k: _host(v) for k, v in opt["mu"].items()},
                "nu": {k: _host(v) for k, v in opt["nu"].items()}}
        if block:
            self._write(step, weights, rest, best_value)
            return

        def write():
            try:
                self._write(step, weights, rest, best_value)
            except Exception as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="ckpt-write")
        self._thread.start()

    def _write(self, step, weights, rest, best_value):
        import torch

        for name, obj in ((f"model_step_{step}.pt", weights),
                          (f"train_state_{step}.pt", rest)):
            path = os.path.join(self.dir, name)
            torch.save(obj, path + ".tmp")
            os.replace(path + ".tmp", path)  # never half a file
        if best_value is not None:
            path = os.path.join(self.dir, "model_step_best.pt")
            torch.save(weights, path + ".tmp")
            os.replace(path + ".tmp", path)
            path = os.path.join(self.dir, "model_step_best.json")
            with open(path + ".tmp", "w") as f:
                json.dump({"step": int(step), "value": float(best_value)}, f)
            os.replace(path + ".tmp", path)
            LOGGER.info("new best checkpoint at step %d (%.4f)", step,
                        best_value)
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.dir, f"train_state_{old}.pt"))

    def best_info(self) -> Optional[dict]:
        """``{"step", "value"}`` of the best export, or None."""
        self.wait()
        path = os.path.join(self.dir, "model_step_best.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def clear_best(self):
        """Remove a previous run's best export (a fresh run in a reused
        ``output_dir`` starts its own maximum; until it first improves,
        ``--ckpt best`` would otherwise resolve to the old weights). Rank 0
        alone removes."""
        from uniter_tpu_torch.parallel.collectives import process_index

        self.wait()
        if process_index() > 0:
            return
        for name in ("model_step_best.pt", "model_step_best.json"):
            path = os.path.join(self.dir, name)
            if os.path.exists(path):
                os.remove(path)
                LOGGER.info("cleared stale best export %s", path)

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None,
                seed: Optional[int] = None):
        """Load the latest (or ``step``'s) train state into ``state`` in
        place; returns it, or None when there is nothing to resume. A
        ``seed`` other than the saved run's is logged: the resumed steps
        then draw other dropout masks than the interrupted run would."""
        import torch

        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        rest = torch.load(os.path.join(self.dir, f"train_state_{step}.pt"),
                          map_location="cpu", weights_only=True)
        weights = torch.load(os.path.join(self.dir, f"model_step_{step}.pt"),
                             map_location="cpu", weights_only=True)
        state.model.load_state_dict(weights, strict=True)
        state.opt.load_masters(weights)
        state.opt.load_state(rest)
        state.step = int(rest["step"])
        if seed is not None and int(seed) != int(rest["seed"]):
            LOGGER.warning("resuming a run saved with seed %d under seed %d",
                           int(rest["seed"]), int(seed))
        return state
