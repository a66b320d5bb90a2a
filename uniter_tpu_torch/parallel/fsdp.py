"""``--fsdp``: the parameters sharded at rest over the ``data`` axis (ZeRO-3).

Every collective here runs over this rank's data group
(``parallel/collectives.py`` ``data_group``: the world without a model
axis). Under a data x model grid the parameters it shards are the rank's
tensor-parallel blocks (``parallel/tp.py`` cuts them first), as the JAX
placement puts ``data`` on an axis that ``model`` left free
(``parallel/mesh.py`` ``_compose_fsdp``): the model ranks of a data group
each shard their own blocks, and a replicated parameter's block is the
same on every model rank.

Counterpart of ``uniter_tpu/training/loop.py`` ``place_state(fsdp=True)``
with ``parallel/mesh.py`` ``param_sharding_full``: there ``jit`` keeps the
parameters and the Adam moments of every leaf whose spec names ``data``
sharded, and inserts the gathers and the gradient reduce-scatters. Here
they are explicit:

  * **Units.** The sharded parameters (``mesh.sharded_names``) fall into
    units, one per ``BertLayer``, one per embedding module (text, image),
    and one per other child of the model that owns any (the pooler, each
    task head). Within a unit, the parameters of one optimizer key
    (decay, learning-rate multiplier, and in master mode the bf16 storage)
    form one flat buffer, padded to a multiple of the data size; the rank
    at data index p keeps block p of it (``_Group``). The block is cut along the flat
    buffer, across parameter boundaries: a layout choice, which changes no
    result. Smaller parameters stay whole on every rank.
  * **At rest** a sharded ``nn.Parameter`` holds no data: it is a
    one-element NaN tensor broadcast to the parameter's shape (so names,
    shapes, dtypes and the device stay what they were). The values live in
    the group's ``block`` (an fp32 leaf: the parameters or, in master mode,
    their masters) and, for bf16-stored parameters, ``block16``.
  * **Forward.** Before a unit's module runs (a forward pre-hook on the
    unit's module and on each module that owns one of its parameters, for
    calls from outside it), its blocks are all-gathered into full flat
    buffers (``_Gather``: in bf16 where the parameters are stored bf16),
    and each parameter slot of its modules holds a view of them. After
    the module returns the slots get their at-rest parameters back, and
    the full buffers are freed: what the autograd graph saved of them (a
    view of a buffer, such as a weight or its transpose, or a view of one
    cast of a parameter) is held as a marker (``saving``), not as the
    tensor.
  * **Backward.** The first marker of a gather that the backward unpacks
    gathers the unit again (also the recompute of ``--remat``, which runs
    the layer's forward again under its own hooks). Then ``_Gather``'s
    backward takes the gradients of the unit's parameters, flattens them
    per group in fp32 and reduce-scatters them: each rank's block
    gradient, summed over the data group, accumulates on ``block.grad``, and
    the unit's full weights and gradient are freed.
  * So between steps no rank holds a full copy of a sharded parameter, and
    during a step only the units whose backward is pending do (and any
    other copy the forward made of them and saved, such as
    ``fused_qkv``'s concatenation). A unit that a step does not run
    (another task's head) receives no gradient: its block's is zero.
  * ``model.state_dict()`` gathers the sharded parameters (a collective:
    every rank calls it together), and ``model.load_state_dict`` scatters
    full tensors into the blocks, so a checkpoint holds full tensors and
    does not depend on the world size (``parallel/tp.py`` then gathers the
    model axis).
  * ``unit_param`` gives a sharded parameter's value outside its unit's
    call (the tied decoders of pretraining read the word table and the
    image projection), gathered with its gradient path.
  * Validation runs under ``local_params``: every unit gathered once
    before it and freed after (JAX ``local_eval_params``), since each rank
    evaluates its own share of the set and the ranks' batch counts differ.

``training/optim.py`` ``FusedAdamW`` updates the blocks in place from
their reduce-scattered gradients; nothing gathers after an update. At
data size 1 a block is the whole buffer, a gather and a reduce-scatter
are copies, and a run is the replicated run to the order of its sums.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

SLOT = Tuple[nn.Module, str]  # (module owning a parameter, its attribute)


def unit_root(name: str) -> str:
    """The module path of the unit that holds parameter ``name``: its
    ``encoder.layer.N``, its ``embeddings`` / ``img_embeddings``, else its
    child of the model (``uniter.pooler``, a head)."""
    parts = name.split(".")[:-1]
    for i in range(len(parts) - 2):
        if parts[i] == "encoder" and parts[i + 1] == "layer":
            return ".".join(parts[:i + 3])
    for i, part in enumerate(parts):
        if part in ("embeddings", "img_embeddings"):
            return ".".join(parts[:i + 1])
    return ".".join(parts[:2] if parts[:1] == ["uniter"] else parts[:1])


def _at_rest(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The data of a sharded parameter at rest: one NaN, broadcast."""
    return torch.full((1,), float("nan"), dtype=dtype,
                      device=p.device).expand(p.shape)


class _Group:
    """One flat buffer of a unit: parameters of one optimizer key and one
    storage dtype (bf16 when ``low``), ``size`` elements padded to a
    multiple of the data size ``world``, this rank's block ``[lo, hi)``."""

    def __init__(self, key, members, world: int, rank: int, low: bool):
        self.key = key
        self.members = members  # (name, slot, shape, offset, numel)
        n = sum(m[4] for m in members)
        self.size = -(-n // world) * world
        self.lo = rank * self.size // world
        self.hi = (rank + 1) * self.size // world
        self.low = low
        self.dtype = torch.bfloat16 if low else torch.float32
        device = members[0][1][0]._parameters[members[0][1][1]].device
        full = torch.zeros(self.size, dtype=torch.float32, device=device)
        for _, (mod, attr), _, ofs, numel in members:
            full[ofs:ofs + numel].copy_(mod._parameters[attr].detach()
                                        .float().reshape(-1))
        # the values this rank updates: parameters, or their fp32 masters
        self.block = nn.Parameter(full[self.lo:self.hi].clone())
        self.block16 = (self.block.detach().to(torch.bfloat16) if low
                        else None)

    def stored(self) -> torch.Tensor:
        """This rank's block as the parameters are stored."""
        return self.block16 if self.low else self.block.detach()

    def load(self, full: torch.Tensor):
        """Set the block from the group's full fp32 buffer."""
        with torch.no_grad():
            self.block.copy_(full[self.lo:self.hi])
            if self.low:
                self.block16.copy_(self.block)

    def stored_bytes(self) -> int:
        t = self.stored()
        return t.numel() * t.element_size()


class _Call:
    """One gather of a unit in a forward: what its backward regathers."""

    def __init__(self, unit: "_Unit"):
        self.unit = unit
        self.fulls: Optional[List[torch.Tensor]] = None

    def full(self, group: int) -> torch.Tensor:
        """Group ``group``'s full buffer, gathered again on first use."""
        if self.fulls is None:
            self.fulls = self.unit.gather_fulls()
        return self.fulls[group]


class _Gather(torch.autograd.Function):
    """Forward: the unit's parameters from its blocks (all-gathered).
    Backward: the blocks' gradients (flattened, reduce-scattered)."""

    @staticmethod
    def forward(ctx, unit, *blocks):
        ctx.unit = unit
        ctx.fsdp_call = call = _Call(unit)  # ``saving`` reads it
        ctx.set_materialize_grads(False)
        fulls = unit.gather_fulls()
        for i, full in enumerate(fulls):
            full.fsdp_call = (call, i)  # a saved view finds its gather
        return tuple(unit.views(fulls))

    @staticmethod
    def backward(ctx, *grads):
        from uniter_tpu_torch.parallel.collectives import reduce_scatter

        ctx.fsdp_call.fulls = None  # the backward's copy is done with
        out, i = [], 0
        for group in ctx.unit.groups:
            flat = torch.zeros(group.size, dtype=torch.float32,
                               device=group.block.device)
            for _, _, _, ofs, numel in group.members:
                if grads[i] is not None:
                    flat[ofs:ofs + numel].copy_(grads[i].reshape(-1))
                i += 1
            out.append(reduce_scatter(torch.empty_like(group.block), flat,
                                      ctx.unit.comm))
        return (None, *out)


class _Unit:
    """The sharded parameters under one module (module docstring)."""

    def __init__(self, name: str, root: nn.Module, groups: List[_Group],
                 comm=None):
        self.name, self.root, self.groups = name, root, groups
        self.comm = comm  # the data group
        self.slots: List[SLOT] = [m[1] for g in groups for m in g.members]
        self.rest = [mod._parameters[attr] for mod, attr in self.slots]
        # slot -> (group, offset, shape) in the gathered buffers
        self.place = [(i, m[3], m[2]) for i, g in enumerate(groups)
                      for m in g.members]
        self.depth = 0

    def gather_fulls(self) -> List[torch.Tensor]:
        """Each group's full flat buffer, all-gathered from the blocks as
        the parameters are stored; no gradient path."""
        from uniter_tpu_torch.parallel.collectives import all_gather

        return [all_gather(torch.empty(g.size, dtype=g.dtype,
                                       device=g.block.device), g.stored(),
                           self.comm)
                for g in self.groups]

    def views(self, fulls) -> List[torch.Tensor]:
        """Every parameter's value in slot order, views of ``fulls``."""
        return [fulls[i][ofs:ofs + math.prod(shape)].view(shape)
                for i, ofs, shape in self.place]

    def gather_views(self) -> List[torch.Tensor]:
        return self.views(self.gather_fulls())

    def gathered(self) -> Tuple[torch.Tensor, ...]:
        """The full parameters with their gradient path to the blocks."""
        return _Gather.apply(self, *[g.block for g in self.groups])

    def enter(self):
        if self.depth == 0:
            for (mod, attr), v in zip(self.slots, self.gathered()):
                mod._parameters[attr] = v
        self.depth += 1

    def exit(self):
        self.depth -= 1
        if self.depth == 0:
            for (mod, attr), p in zip(self.slots, self.rest):
                mod._parameters[attr] = p

    # -- state dicts: gather on save, scatter on load ----------------------
    def state_dict_hook(self, module, state_dict, prefix, local_metadata):
        names = [m[0] for g in self.groups for m in g.members]
        views = ([mod._parameters[attr].detach() for mod, attr in self.slots]
                 if self.depth else self.gather_views())
        for name, view in zip(names, views):
            key = prefix + self._relative(name)
            if key in state_dict:
                state_dict[key] = view.clone()

    def load_pre_hook(self, module, state_dict, prefix, *args):
        """Give each slot a full fp32 tensor to load into (the current
        values, for keys the state dict lacks)."""
        for (mod, attr), v in zip(self.slots, self.gather_views()):
            mod._parameters[attr] = nn.Parameter(v.float(),
                                                 requires_grad=False)

    def load_post_hook(self, module, incompatible_keys):
        """The loaded full tensors into the blocks; the slots back at
        rest."""
        for g in self.groups:
            full = torch.zeros(g.size, dtype=torch.float32,
                               device=g.block.device)
            for _, (mod, attr), _, ofs, numel in g.members:
                full[ofs:ofs + numel].copy_(
                    mod._parameters[attr].detach().float().reshape(-1))
            g.load(full)
        for (mod, attr), p in zip(self.slots, self.rest):
            mod._parameters[attr] = p

    def _relative(self, name: str) -> str:
        return name[len(self.name) + 1:] if self.name else name


class Sharding:
    """The units of one model (module docstring); built by ``shard``."""

    def __init__(self, units: List[_Unit], names: Dict[str, Tuple]):
        self.units = units
        self.where = names  # parameter name -> (unit, group, member)

    @property
    def groups(self) -> List[_Group]:
        return [g for u in self.units for g in u.groups]


def shard(model: nn.Module, names: Sequence[str],
          key_of: Callable[[str], tuple], low_of: Callable[[str], bool]
          ) -> Sharding:
    """Shard the parameters ``names`` of ``model`` at rest over the data
    group (module docstring) and install the hooks; ``key_of(name)`` is
    the optimizer group key, ``low_of(name)`` True for a bf16-stored
    parameter."""
    from uniter_tpu_torch.parallel.collectives import (
        data_group, data_index, data_size)

    world, rank, comm = data_size(), data_index(), data_group()
    modules = dict(model.named_modules())
    by_unit: Dict[str, Dict[tuple, list]] = {}
    for name, p in model.named_parameters():
        if name not in names:
            continue
        owner, _, attr = name.rpartition(".")
        key = (key_of(name), low_of(name))
        by_unit.setdefault(unit_root(name), {}).setdefault(key, []).append(
            (name, (modules[owner], attr), tuple(p.shape)))
    units, where = [], {}
    for root, keyed in by_unit.items():
        groups = []
        for (key, low), members in keyed.items():
            ofs, placed = 0, []
            for name, slot, shape in members:
                numel = math.prod(shape)
                placed.append((name, slot, shape, ofs, numel))
                ofs += numel
            groups.append(_Group(key, placed, world, rank, low))
        unit = _Unit(root, modules[root], groups, comm)
        i = 0
        for g in groups:
            for m in g.members:
                mod, attr = m[1]
                p = mod._parameters[attr]
                p.data = _at_rest(p, g.dtype)
                mod.__dict__.setdefault("_fsdp_slots", {})[attr] = (unit, i)
                where[m[0]] = (unit, g, m)
                i += 1
        _install(unit)
        units.append(unit)
    sharding = Sharding(units, where)
    model._fsdp = sharding
    return sharding


def _install(unit: _Unit):
    owners = {id(m): m for m, _ in unit.slots if m is not unit.root}
    for mod in [unit.root, *owners.values()]:
        mod.register_forward_pre_hook(lambda *_: unit.enter())
        mod.register_forward_hook(lambda *_: unit.exit(), always_call=True)
    unit.root._register_state_dict_hook(unit.state_dict_hook)
    unit.root._register_load_state_dict_pre_hook(unit.load_pre_hook,
                                                 with_module=True)
    unit.root.register_load_state_dict_post_hook(unit.load_post_hook)


def sharding_of(model: nn.Module) -> Optional[Sharding]:
    return getattr(model, "_fsdp", None)


def unit_param(module: nn.Module, attr: str = "weight") -> torch.Tensor:
    """``module.<attr>``'s value: the parameter (or, inside its unit's
    call, the gathered view in its slot); for a sharded one outside that
    call, its unit gathered with the gradient path."""
    slot = module.__dict__.get("_fsdp_slots", {}).get(attr)
    if slot is None or slot[0].depth > 0:
        return module._parameters[attr]
    unit, i = slot
    return unit.gathered()[i]


class _Marker:
    """What a saved tensor was: a view (size, stride, offset) of group
    ``group``'s gathered buffer, or with ``dtype`` of the cast of
    parameter ``group`` (a slot index) to that dtype."""

    __slots__ = ("call", "group", "dtype", "view")

    def __init__(self, call, group, dtype, t):
        self.call, self.group, self.dtype = call, group, dtype
        self.view = (t.size(), t.stride(), t.storage_offset())

    def value(self) -> torch.Tensor:
        if self.dtype is None:
            src = self.call.full(self.group)
        else:
            i, ofs, shape = self.call.unit.place[self.group]
            src = self.call.full(i)[ofs:ofs + math.prod(shape)].view(
                shape).to(self.dtype)
        return src.as_strided(*self.view)


def _pack(t: torch.Tensor):
    """A saved tensor that is a view of a gathered buffer (a parameter, a
    transposed or reshaped one), or a view of one cast of a gathered
    parameter, becomes a ``_Marker``; the backward gathers the buffer
    again (``_Call.full``)."""
    base = t if t._base is None else t._base
    tag = getattr(base, "fsdp_call", None)
    if tag is not None:
        return _Marker(*tag, None, t)
    fn = base.grad_fn
    if fn is not None and fn.name() == "ToCopyBackward0":
        src, nr = fn.next_functions[0]
        call = getattr(src, "fsdp_call", None)
        if call is not None:
            return _Marker(call, nr, base.dtype, t)
    return t


def _unpack(x):
    return x.value() if isinstance(x, _Marker) else x


@contextlib.contextmanager
def local_params(model: nn.Module):
    """Every sharded parameter of ``model`` gathered once, without a
    gradient path, for the body (JAX ``infer.py`` ``local_eval_params``):
    a process-sharded evaluation may run another number of batches on
    each rank, so none of its forwards may gather. A collective: every
    rank enters it together. Nothing for another model."""
    units = sharding_of(model).units if sharding_of(model) else []
    with torch.no_grad():
        for unit in units:
            unit.enter()
    try:
        yield
    finally:
        for unit in units:
            unit.exit()


def saving(model: nn.Module):
    """The context a sharded model's forward runs in while it records a
    graph: what the graph saves of a gathered parameter is a marker, so
    the gathered buffers are freed after each unit's forward (module
    docstring). A null context for any other model."""
    if sharding_of(model) is None or not torch.is_grad_enabled():
        return contextlib.nullcontext()
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)
