"""Process-level collectives over ``torch.distributed`` (counterpart of
``uniter_tpu/parallel/collectives.py``, reference utils/distributed.py).

One process drives one device. A run launched by ``torchrun`` (or with the
variables it sets: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) joins a process group in
``init_distributed``: NCCL on the card, gloo on the CPU or, with
``--dist_backend gloo``, on the card (NCCL refuses two ranks on one GPU;
gloo runs every collective used here on CUDA tensors as they are).
Without a process group every function here is the identity of world size
1 and launches nothing, so a single-process run is what it was.

The JAX package gets its gradient and parameter collectives from the
sharding of its jitted step; here they are explicit calls:

  * ``all_reduce_sum``: the gradient sum of data parallelism, the loss
    denominators of the global batch and the reported metrics;
  * ``reduce_scatter`` / ``all_gather`` on flat buffers: the sharded
    optimizer (``--fsdp``);
  * ``all_gather_list`` / ``all_gather_array`` / ``barrier``: the host
    collectives of evaluation, checkpoints and preemption.
"""

from __future__ import annotations

import atexit
import os
import pickle
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def is_distributed() -> bool:
    """True inside a process group (also at world size 1)."""
    return dist.is_available() and dist.is_initialized()


def num_processes() -> int:
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def launched() -> bool:
    """True when the launcher's variables are set (``torchrun``)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(device="cuda", backend: Optional[str] = None) -> str:
    """Join the process group a launcher describes and return this rank's
    device: ``cuda:LOCAL_RANK`` for a ``cuda`` device without an index
    (``LOCAL_RANK`` modulo the card count under gloo, so several ranks may
    share a card), the device as given otherwise. Without the launcher's
    variables nothing happens and ``device`` comes back unchanged.
    ``backend`` defaults to NCCL on the card and gloo on the CPU."""
    device = str(device)
    if not launched():
        return device
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown dist backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            n_cards = torch.cuda.device_count()
            if backend == "nccl" and local >= n_cards:
                raise ValueError(
                    f"local rank {local} has no card of its own ({n_cards} "
                    "cards): NCCL takes one card a rank; --dist_backend "
                    "gloo lets ranks share a card")
            dev = torch.device("cuda", local % max(n_cards, 1))
        torch.cuda.set_device(dev)
        device = str(dev)
    if not is_distributed():
        dist.init_process_group(backend, init_method="env://")
        # leave the group before the interpreter tears down: a rank that
        # exits with gloo's threads alive can abort ("terminate called")
        atexit.register(_leave)
    return device


def _leave():
    if is_distributed():
        dist.destroy_process_group()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place; returns it."""
    if is_distributed():
        dist.all_reduce(t)
    return t


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks as a new, detached tensor: the
    denominator of a mean over the global batch (each rank's loss is its
    numerator over this). ``t`` itself without a process group."""
    if not is_distributed():
        return t
    return all_reduce_sum(t.detach().clone())


def reduce_scatter(out: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """``out`` (``flat.numel() // world`` elements) = this rank's block of
    the sum of ``flat`` over the ranks."""
    if not is_distributed():
        return out.copy_(flat)
    dist.reduce_scatter_tensor(out, flat)
    return out


def all_gather(flat: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
    """``flat`` (1-D, contiguous) = the ranks' ``shard``s end to end, in
    rank order, bit for bit: the bytes are gathered, so any dtype goes."""
    if not is_distributed():
        return flat.copy_(shard)
    dist.all_gather_into_tensor(flat.view(torch.uint8),
                                shard.contiguous().view(torch.uint8))
    return flat


def _comm_device():
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_list(data: Any) -> List[Any]:
    """Every rank's picklable ``data``, in rank order (payloads of unequal
    size: padded to the longest; reference utils/distributed.py:179-195).
    ``[data]`` without a process group."""
    if not is_distributed():
        return [data]
    dev = _comm_device()
    payload = torch.from_numpy(
        np.frombuffer(pickle.dumps(data), dtype=np.uint8).copy()).to(dev)
    world = num_processes()
    size = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    sizes = torch.empty(world, dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(sizes, size)
    sizes = sizes.cpu().tolist()
    longest = max(sizes)
    padded = torch.zeros(longest, dtype=torch.uint8, device=dev)
    padded[:payload.numel()] = payload
    gathered = torch.empty(world * longest, dtype=torch.uint8, device=dev)
    dist.all_gather_into_tensor(gathered, padded)
    gathered = gathered.cpu().numpy()
    return [pickle.loads(gathered[i * longest:i * longest + n].tobytes())
            for i, n in enumerate(sizes)]


def all_gather_array(x: np.ndarray) -> np.ndarray:
    """Every rank's equal-shape array stacked on a new axis 0 (reference
    ``hvd.allgather`` of the retrieval score rows, utils/itm_eval.py:75)."""
    x = np.ascontiguousarray(x)
    if not is_distributed():
        return x[None]
    dev = _comm_device()
    t = torch.from_numpy(x.copy()).to(dev)
    out = torch.empty((num_processes() * t.numel(),), dtype=t.dtype,
                      device=dev)
    dist.all_gather_into_tensor(out, t.reshape(-1))
    return out.cpu().numpy().reshape((num_processes(),) + x.shape)


def barrier():
    """Every rank waits here for the others."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
