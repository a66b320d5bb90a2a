"""The process mesh and the placement rules (counterpart of
``uniter_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, model)`` mesh: the
batch is sharded over ``data``, the encoder's projections over ``model``
(Megatron tensor parallelism), and with ``--fsdp`` the parameters over
``data`` too (ZeRO-3); ``jit`` inserts the collectives. Here one process
drives one device and ``make_mesh`` lays the processes out the same way:
rank r sits at (r // model, r % model), as JAX's ``reshape(data, model)``
places its devices, and the two axes are process groups
(``parallel/collectives.py`` ``set_grid``). The rules are plain functions
of a parameter's name and shape:

  * ``_tp_spec``: column-sharded QKV and FFN-in kernels and their biases,
    row-sharded output projections, over ``model``;
  * ``_compose_fsdp``: ``data`` on the largest free axis it divides, for
    parameters of at least ``fsdp_min_size`` elements;
  * ``param_sharding_full``: both, for every parameter, as a tuple of axis
    names (or None) per dimension of this package's tensor.

A rule sees each parameter as the JAX tree holds it (``models.checkpoint
.reference_leaf``): a ``Dense`` kernel [in, out] where the tensor here is
[out, in], and each encoder tensor as the stack of all its layers, so the
specs are the JAX package's, carried through the weight bridge. The
parameters whose spec names ``model`` are cut into the rank's block
(``parallel/tp.py``); under ``--fsdp`` those whose spec names ``data`` are
sharded at rest over the data group, with their optimizer state
(``parallel/fsdp.py``, ``training/optim.py``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Iterable, Optional, Tuple

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: every process
    model: int = 1
    # shard parameters and their optimizer state over data at rest (ZeRO-3,
    # parallel/fsdp.py)
    fsdp: bool = False
    # smallest parameter (elements) to shard; smaller ones stay replicated
    fsdp_min_size: int = 2 ** 16


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes: ``data`` processes (one device each) by ``model``."""

    data: int = 1
    model: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def make_mesh(config: MeshConfig = MeshConfig()) -> Mesh:
    """The ``data`` x ``model`` grid of the running process group
    (``data`` -1: every process over ``model``). With ``model`` > 1 it
    builds the grid's process groups (a collective: every rank calls it
    before building the model's placement, loaders and train step; the
    same grid again is a no-op, another one raises);
    ``model`` 1 is the world along ``data``. Returns the mesh, also kept
    as ``current_mesh()``."""
    from uniter_tpu_torch.parallel.collectives import num_processes, set_grid

    n = num_processes()
    if config.model < 1 or n % config.model:
        raise ValueError(f"mesh model={config.model} does not divide {n} "
                         "processes")
    data = config.data if config.data > 0 else n // config.model
    if data * config.model != n:
        raise ValueError(f"mesh {data}x{config.model} != {n} processes")
    set_grid(data, config.model)
    return current_mesh()


def current_mesh() -> Mesh:
    """The grid ``make_mesh`` built, or every process along ``data``."""
    from uniter_tpu_torch.parallel.collectives import data_size, model_size

    return Mesh(data=data_size(), model=model_size())


# Megatron-style rules on the JAX tree's paths (the JAX package's lists)
_TP_COL = ("attention/query/kernel", "attention/key/kernel",
           "attention/value/kernel", "intermediate_dense/kernel")
_TP_ROW = ("attention/output_dense/kernel", "output_dense/kernel")
_TP_COL_BIAS = ("attention/query/bias", "attention/key/bias",
                "attention/value/bias", "intermediate_dense/bias")


def _tp_spec(path: str, shape, mesh: Mesh) -> Spec:
    """The ``model``-axis spec of the JAX leaf ``path`` of ``shape``."""
    n = mesh.shape["model"]
    ndim = len(shape)
    none = (None,) * ndim
    for pat in _TP_COL + _TP_COL_BIAS:
        if path.endswith(pat) and shape[-1] % n == 0:
            return none[:-1] + ("model",)
    for pat in _TP_ROW:
        # the contract axis (-2 of the kernel) is split
        if path.endswith(pat) and ndim >= 2 and shape[-2] % n == 0:
            return none[:-2] + ("model", None)
    return none


def _compose_fsdp(spec: Spec, shape, mesh: Mesh, min_size: int) -> Spec:
    """``spec`` with ``data`` on its largest free axis that the data size
    divides (ties: the earlier axis), when the leaf has ``min_size``
    elements or more."""
    if math.prod(shape) < min_size:
        return spec
    n = mesh.shape["data"]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for ax in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if parts[ax] is None and shape[ax] % n == 0:
            parts[ax] = "data"
            return tuple(parts)
    return spec


def param_sharding_full(named_shapes: Iterable[Tuple[str, tuple]],
                        mesh: Mesh, config: MeshConfig = MeshConfig()
                        ) -> Dict[str, Spec]:
    """name -> spec (one axis name or None per dimension of the tensor
    here) for ``(name, shape)`` pairs of this package's parameters: TP over
    ``model`` when the mesh has one, composed with FSDP over ``data`` under
    ``config.fsdp``. Each leaf of the JAX tree gets its rule once; an
    encoder tensor takes its stack's spec without the layer axis (a stack
    sharded on that axis leaves each layer's tensor whole)."""
    from uniter_tpu_torch.models.checkpoint import reference_leaf

    named_shapes = [(n, tuple(s)) for n, s in named_shapes]
    n_layers = len({m.group(1) for n, _ in named_shapes
                    for m in [re.search(r"encoder\.layer\.(\d+)\.", n)] if m})
    tp = mesh.shape["model"] > 1
    out = {}
    for name, shape in named_shapes:
        path, kind, stacked = reference_leaf(name)
        ref = shape[::-1] if kind == "linear_w" else shape
        if stacked:
            ref = (n_layers,) + ref
        spec = _tp_spec(path, ref, mesh) if tp else (None,) * len(ref)
        if config.fsdp:
            spec = _compose_fsdp(spec, ref, mesh, config.fsdp_min_size)
        spec = tuple(spec) + (None,) * (len(ref) - len(spec))
        if stacked:
            spec = spec[1:]
        out[name] = spec[::-1] if kind == "linear_w" else spec
    return out


def sharded_names(named_shapes, mesh: Mesh, config: MeshConfig):
    """The parameters whose spec names ``data``: those ``--fsdp`` shards
    at rest (``parallel/fsdp.py``)."""
    specs = param_sharding_full(named_shapes, mesh, config)
    return {n for n, s in specs.items() if "data" in s}
