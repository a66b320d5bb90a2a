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
  * ``reduce_scatter`` / ``all_gather`` on flat buffers, any dtype for the
    gather (bytes), fp32 for the sum: ``--fsdp``'s parameter gathers in
    the forward and the backward and its gradient reduce-scatters
    (``parallel/fsdp.py``), and the gathers of the sharded optimizer
    state;
  * ``all_gather_list`` / ``all_gather_array`` / ``barrier``: the host
    collectives of evaluation, checkpoints and preemption.

Each takes an optional process group (``group``; None is the world). A
data x model grid (``parallel/mesh.py`` ``make_mesh`` with ``model`` > 1)
builds its groups here once (``set_grid``): rank r sits at (d, m) =
(r // model, r % model), the ``model`` group of d is the ``model``
consecutive ranks d*model..., the ``data`` group of m the strided ranks
m, m + model, ... ``data_index``/``data_size`` and ``model_index``/
``model_size`` give the rank's place; without a grid the data axis is the
world and the model axis one process, so ``data_group()`` is the world.
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

# the data x model grid of the running group (``set_grid``): axis sizes,
# this rank's coordinates and its two groups; None without a grid
_GRID: Optional[dict] = None


def is_distributed() -> bool:
    """True inside a process group (also at world size 1)."""
    return dist.is_available() and dist.is_initialized()


def num_processes() -> int:
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def set_grid(data: int, model: int):
    """Build the data x model grid's groups (module docstring) once; every
    rank calls ``dist.new_group`` for every group, in the same order.
    ``model`` 1 builds none: the data axis is the world. The same grid
    again is a no-op; another grid raises, since the layers, the optimizer
    and the ``--fsdp`` units already built hold the first grid's groups."""
    global _GRID
    if data * model != num_processes():
        raise ValueError(f"grid {data}x{model} != {num_processes()} "
                         "processes")
    if _GRID is not None:
        if (_GRID["data"], _GRID["model"]) == (data, model):
            return
        raise ValueError(f"a {_GRID['data']}x{_GRID['model']} grid is built "
                         f"already: a {data}x{model} grid would leave what "
                         "was placed on it on the old groups")
    if model == 1:
        return
    rank = process_index()
    grid = {"data": data, "model": model, "d": rank // model,
            "m": rank % model}
    for d in range(data):  # consecutive ranks
        g = dist.new_group([d * model + m for m in range(model)])
        if d == grid["d"]:
            grid["model_group"] = g
    for m in range(model):  # strided ranks
        g = dist.new_group([d * model + m for d in range(data)])
        if m == grid["m"]:
            grid["data_group"] = g
    _GRID = grid


def data_size() -> int:
    """Processes along the data axis (every process without a grid)."""
    return _GRID["data"] if _GRID else num_processes()


def data_index() -> int:
    """This rank's place on the data axis: its block of the batch."""
    return _GRID["d"] if _GRID else process_index()


def model_size() -> int:
    """Processes along the model (tensor-parallel) axis: 1 without a
    grid."""
    return _GRID["model"] if _GRID else 1


def model_index() -> int:
    return _GRID["m"] if _GRID else 0


def data_group():
    """The group of this rank's data axis (None: the world)."""
    return _GRID["data_group"] if _GRID else None


def model_group():
    """The group of this rank's model axis (None without a grid)."""
    return _GRID["model_group"] if _GRID else None


def _size(group) -> int:
    return dist.get_world_size(group) if is_distributed() else 1


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
    global _GRID
    _GRID = None
    if is_distributed():
        dist.destroy_process_group()


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` in place; returns it."""
    if is_distributed():
        dist.all_reduce(t, group=group)
    return t


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the data axis as a new, detached tensor: the
    denominator of a mean over the global batch (each rank's loss is its
    numerator over this; the model ranks of a data group hold the same
    block). ``t`` itself when the data axis is one process."""
    if data_size() == 1:
        return t
    return all_reduce_sum(t.detach().clone(), data_group())


def reduce_scatter(out: torch.Tensor, flat: torch.Tensor,
                   group=None) -> torch.Tensor:
    """``out`` (``flat.numel() // size`` elements) = this rank's block of
    the sum of ``flat`` over the ranks of ``group``."""
    if _size(group) == 1:
        return out.copy_(flat)
    dist.reduce_scatter_tensor(out, flat, group=group)
    return out


def all_gather(flat: torch.Tensor, shard: torch.Tensor,
               group=None) -> torch.Tensor:
    """``flat`` (1-D, contiguous) = the ``shard``s of ``group``'s ranks end
    to end, in rank order, bit for bit: the bytes are gathered, so any
    dtype goes."""
    if _size(group) == 1:
        return flat.copy_(shard)
    dist.all_gather_into_tensor(flat.view(torch.uint8),
                                shard.contiguous().view(torch.uint8),
                                group=group)
    return flat


def _comm_device():
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_list(data: Any, group=None) -> List[Any]:
    """Every rank's picklable ``data`` (of ``group``'s ranks), in rank
    order (payloads of unequal size: padded to the longest; reference
    utils/distributed.py:179-195). ``[data]`` without a process group."""
    if _size(group) == 1:
        return [data]
    dev = _comm_device()
    payload = torch.from_numpy(
        np.frombuffer(pickle.dumps(data), dtype=np.uint8).copy()).to(dev)
    world = _size(group)
    size = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    sizes = torch.empty(world, dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(sizes, size, group=group)
    sizes = sizes.cpu().tolist()
    longest = max(sizes)
    padded = torch.zeros(longest, dtype=torch.uint8, device=dev)
    padded[:payload.numel()] = payload
    gathered = torch.empty(world * longest, dtype=torch.uint8, device=dev)
    dist.all_gather_into_tensor(gathered, padded, group=group)
    gathered = gathered.cpu().numpy()
    return [pickle.loads(gathered[i * longest:i * longest + n].tobytes())
            for i, n in enumerate(sizes)]


def all_gather_array(x: np.ndarray, group=None) -> np.ndarray:
    """Every rank's (of ``group``) equal-shape array stacked on a new axis
    0 (reference ``hvd.allgather`` of the retrieval score rows,
    utils/itm_eval.py:75)."""
    x = np.ascontiguousarray(x)
    n = _size(group)
    if n == 1:
        return x[None]
    dev = _comm_device()
    t = torch.from_numpy(x.copy()).to(dev)
    out = torch.empty((n * t.numel(),), dtype=t.dtype, device=dev)
    dist.all_gather_into_tensor(out, t.reshape(-1), group=group)
    return out.cpu().numpy().reshape((n,) + x.shape)


def barrier():
    """Every rank waits here for the others."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
