"""The tensor-parallel ``model`` axis: Megatron's column- and row-parallel
projections over the model group (counterpart of the JAX package's
``_tp_spec`` placement, ``uniter_tpu/parallel/mesh.py:92-144``, which
GSPMD executes there).

``shard_model`` cuts each encoder layer's parameters that
``parallel/mesh.py`` ``param_sharding_full`` puts on ``model`` into this
rank's block, in place:

  * column-parallel: the Q/K/V projections and the FFN's intermediate
    dense, weights [out, in] and biases [out] cut along out. Rank m of n
    holds rows ``[m*out/n, (m+1)*out/n)``: for Q/K/V the heads
    ``[m*H/n, (m+1)*H/n)``, for the FFN the columns ``[m*D_mid/n, ...)``;
  * row-parallel: the attention output dense and the FFN's output dense,
    weights cut along in (the contract axis); their biases stay whole.

Everything else (embeddings, LayerNorms, pooler, task heads) stays whole on
every model rank. A layer then computes, for input x replicated on the
model ranks,

    x -> copy_to_region -> column-parallel GEMM(s) -> local heads / GELU
      -> row-parallel GEMM (no bias) -> reduce_from_region -> + bias

``copy_to_region`` is the identity forward and the all-reduce of the
gradient over the model group backward; ``reduce_from_region`` the
all-reduce forward and the identity backward (Megatron's f and g). The
partial sums are all-reduced in fp32 (a bf16 partial is widened first),
the bias is added once after the sum, and the result is cast back to the
activations' dtype. Every model rank of a data group then holds the same
activations, draws the same seeds at the same row base, and the tails
(K3-K6) and heads run replicated; the attention masks of a rank's heads
are its head block of the one process's (``ops/attention.py``,
``heads_total`` and ``head0``).

The placement refuses a grid whose ``model`` does not divide the hidden
size, the heads and the FFN width: a head cannot be split across ranks,
so a layer is never half-sharded (JAX's ``_tp_spec`` would leave such a
leaf whole and let GSPMD reshard around it).

``model.state_dict()`` gathers each block over the model group (after
``--fsdp``'s gathers over the data group), so a checkpoint holds full
tensors by name whatever the grid; ``model.load_state_dict`` of full
tensors takes each rank's block. Every rank of a model group calls them
together. ``shard_state`` / ``gather_state`` do the same for any dict of
tensors by parameter name (the optimizer's moments and masters).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn


class _CopyToRegion(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from uniter_tpu_torch.parallel.collectives import all_reduce_sum

        return all_reduce_sum(g.clone(), ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    """The all-reduce over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        from uniter_tpu_torch.parallel.collectives import all_reduce_sum

        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_region(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToRegion.apply(x, group)


def reduce_from_region(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromRegion.apply(x, group)


@dataclasses.dataclass(frozen=True)
class TpRank:
    """This rank's place on the model axis, as the layers read it."""

    group: object
    size: int
    index: int


def row_parallel(part: torch.Tensor, bias: torch.Tensor,
                 tp: TpRank) -> torch.Tensor:
    """A row-parallel projection's output from this rank's partial
    product: summed over the model group in fp32, plus the bias once, in
    the partial's dtype."""
    out = reduce_from_region(part.float(), tp.group) + bias.float()
    return out.to(part.dtype)


class TpLayout:
    """The TP-sharded parameters of one model: name -> (axis of the
    tensor here that is cut, full shape), and this rank's place."""

    def __init__(self, axes: Dict[str, Tuple[int, tuple]], rank: TpRank):
        self.axes = axes
        self.rank = rank

    def __contains__(self, name: str) -> bool:
        return name in self.axes

    def full_shape(self, name: str, shape) -> tuple:
        if name not in self.axes:
            return tuple(shape)
        return self.axes[name][1]

    def block(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full tensor ``full`` (a copy)."""
        axis, _ = self.axes[name]
        n, m = self.rank.size, self.rank.index
        width = full.shape[axis] // n
        return full.narrow(axis, m * width, width).contiguous()

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every model rank's block (a collective
        over the model group)."""
        from uniter_tpu_torch.parallel.collectives import all_gather

        axis, _ = self.axes[name]
        n = self.rank.size
        local = local.contiguous()
        flat = all_gather(torch.empty(n * local.numel(), dtype=local.dtype,
                                      device=local.device),
                          local.reshape(-1), self.rank.group)
        return torch.cat(list(flat.view(n, *local.shape)), dim=axis)


def tp_axes(named_shapes, mesh) -> Dict[str, Tuple[int, tuple]]:
    """name -> (cut axis, full shape) for the ``(name, full shape)``
    pairs whose spec names ``model`` (``param_sharding_full``)."""
    from uniter_tpu_torch.parallel.mesh import MeshConfig, param_sharding_full

    named_shapes = [(n, tuple(s)) for n, s in named_shapes]
    shapes = dict(named_shapes)
    specs = param_sharding_full(named_shapes, mesh, MeshConfig())
    return {n: (spec.index("model"), shapes[n])
            for n, spec in specs.items() if "model" in spec}


def _check_divides(model: nn.Module, n: int):
    """Refuse a model axis that does not divide every layer's hidden
    size, heads and FFN width."""
    from uniter_tpu_torch.models.encoder import BertLayer

    for name, mod in model.named_modules():
        if not isinstance(mod, BertLayer):
            continue
        cfg = mod.cfg
        for what, size in (("hidden size", cfg.hidden_size),
                           ("attention heads", cfg.num_attention_heads),
                           ("intermediate size", cfg.intermediate_size)):
            if size % n:
                raise ValueError(
                    f"a model axis of {n} does not divide {name}'s {what} "
                    f"{size}: tensor parallelism splits whole heads and "
                    "FFN columns, and never half-shards a layer")


def shard_model(model: nn.Module) -> Optional[TpLayout]:
    """Cut ``model``'s TP-sharded parameters into this rank's blocks on
    the grid ``parallel/mesh.py`` ``make_mesh`` built, in place (module
    docstring), tell its layers their place, and install the state-dict
    gather and scatter. Nothing (None) when the grid has no model axis.
    Call it on full parameters, before the optimizer (and ``--fsdp``) is
    built."""
    from uniter_tpu_torch.models.encoder import BertAttention, BertLayer
    from uniter_tpu_torch.parallel.collectives import (
        model_group, model_index)
    from uniter_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    n = mesh.shape["model"]
    if n == 1:
        return None
    if tp_of(model) is not None:
        raise ValueError("the model is already tensor-parallel")
    _check_divides(model, n)
    rank = TpRank(model_group(), n, model_index())
    params = dict(model.named_parameters())
    layout = TpLayout(tp_axes([(k, p.shape) for k, p in params.items()],
                              mesh), rank)
    n_layers = sum(isinstance(m, BertLayer) for m in model.modules())
    if len(layout.axes) != 10 * n_layers:  # 6 weights, 4 biases a layer
        raise ValueError(f"{len(layout.axes)} tensor-parallel parameters "
                         f"for {n_layers} layers")
    with torch.no_grad():
        for name in layout.axes:
            params[name].data = layout.block(name, params[name].data)
    for mod in model.modules():
        if isinstance(mod, (BertAttention, BertLayer)):
            mod.tp = rank
    model._tp = layout
    model._register_state_dict_hook(_gather_hook)
    model._register_load_state_dict_pre_hook(_block_hook, with_module=True)
    return layout


def tp_of(model: nn.Module) -> Optional[TpLayout]:
    return getattr(model, "_tp", None)


def follow(module: nn.Module, src: nn.Module) -> nn.Module:
    """``module`` (a fresh module of ``src``'s structure, such as a
    ``BertLayerCLS`` for a ``BertLayer``) with ``src``'s parameter shapes
    (its TP blocks, uninitialised: load ``src.state_dict()`` next) and
    place on the model axis."""
    shapes = {n: p.shape for n, p in src.named_parameters()}
    with torch.no_grad():
        for n, p in module.named_parameters():
            if p.shape != shapes[n]:
                p.data = p.data.new_empty(shapes[n])
    for mine, theirs in zip(module.modules(), src.modules()):
        if getattr(theirs, "tp", None) is not None:
            mine.tp = theirs.tp
    return module


def _gather_hook(module, state_dict, prefix, local_metadata):
    layout = module._tp
    for name in layout.axes:
        key = prefix + name
        if key in state_dict:
            state_dict[key] = layout.gather(name, state_dict[key])


def _block_hook(module, state_dict, prefix, *args):
    layout = module._tp
    for name, (_, full) in layout.axes.items():
        key = prefix + name
        if key in state_dict and tuple(state_dict[key].shape) == full:
            state_dict[key] = layout.block(name, state_dict[key])


def shard_state(full_state: Dict[str, torch.Tensor],
                layout: Optional[TpLayout]) -> Dict[str, torch.Tensor]:
    """``full_state`` (full tensors by parameter name) with each tensor
    that ``layout`` (``shard_model``'s; None: no model axis) shards cut
    to this rank's block."""
    if layout is None:
        return full_state
    return {k: layout.block(k, v) if k in layout else v
            for k, v in full_state.items()}


def gather_state(state: Dict[str, torch.Tensor],
                 layout: Optional[TpLayout]) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_state``: a collective over the model group
    (every rank of it calls it with the same names)."""
    if layout is None:
        return state
    return {k: layout.gather(k, v) if k in layout else v
            for k, v in state.items()}
