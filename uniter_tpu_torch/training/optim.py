"""AdamW, Adam and Adamax as the JAX package computes them (counterpart of
``uniter_tpu/training/optim.py``: ``decay_mask``, ``head_mask``,
``fused_adamw``, ``build_optimizer``).

The update is not ``torch.optim.AdamW``'s. Per parameter, in fp32:

    g   = grad * clip,  clip = min(1, max_norm / max(|grads|, max_norm))
    mu  = b1 mu + (1 - b1) g;   nu = b2 nu + (1 - b2) g^2
    u   = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p   [decay]
    p  -= lr(t - 1) * lr_mul * u

The clip factor comes from the fp32 global norm of all gradients before
the update; the learning rate is read at the OLD count; the decay term is
scaled by ``lr_mul`` with the rest (optim.py:131-160). Moments may be
stored in bfloat16: their arithmetic is fp32 and each is rounded once on
store.

``optim="adam"`` is ``optax.adam`` in the JAX package's chain (clip, the
core, the learning rate, the head multiplier; optim.py:233-249): the
update above with no decay term. ``optim="adamax"`` is ``optax.adamax``,
whose infinity moment takes eps inside the max and has no bias correction
(optax ``tree_update_infinity_moment``):

    nu = max(|g| + eps, b2 nu);   u = (mu / (1 - b1^t)) / nu

Both keep fp32 moments, as the chain passes them no moment dtype.

On the card the optimizer step is bound by memory traffic, so parameters
live in a few flat fp32 buffers, one per (decay, lr_mul) group, and each
``nn.Parameter``'s data becomes a view into its group's buffer; the
gradients are gathered into one flat buffer per group. A step is then a
dozen elementwise passes over each group, not a dozen per parameter.

Master-weight mode (``master=True``, ``--param_dtype bfloat16``; JAX
``fused_adamw(master=True)``, ``driver.py`` ``maybe_cast_param_storage``,
``step.py:48-56``): the flat fp32 buffers are the masters, initialised
from the parameters' fp32 values; every parameter of at least 2**16
elements (embeddings and GEMM weights) is then stored as a bf16 tensor of
its own, while the smaller ones (LayerNorm weights and biases, the other
biases) stay fp32 views into the masters. A step updates the masters in
fp32 and re-casts each bf16 parameter from its master with one
round-to-nearest-even; ``masters()`` gives the fp32 values that exports
and resumes carry.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from uniter_tpu_torch.models.encoder import LayerNorm
from uniter_tpu_torch.utils import trace


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True where weight decay applies: the weights of linear layers and
    embedding tables; never biases or LayerNorm parameters (reference
    optim/misc.py:14). Decided by module type, since every parameter here
    is named ``weight`` or ``bias``: ``vqa_output.0.weight`` (a Linear)
    decays, ``vqa_output.2.weight`` (the head's LayerNorm) does not. The
    cross-attention's ``in_proj_weight`` decays and its ``in_proj_bias``
    does not, as the reference's substring rule has it."""
    out = {}
    for mname, module in model.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            if pname in ("bias", "in_proj_bias"):
                out[key] = False
            elif pname == "in_proj_weight" or (
                    pname == "weight" and isinstance(
                        module, (nn.Linear, nn.Embedding))):
                out[key] = True
            elif pname == "weight" and isinstance(module, LayerNorm):
                out[key] = False
            else:
                raise ValueError(
                    f"no weight-decay rule for {key} "
                    f"({type(module).__name__})")
    return out


def head_mask(names: Iterable[str], head_paths: Sequence[str]) -> Dict[str, bool]:
    """True for parameters whose name contains any of ``head_paths`` (the
    task-head groups that get ``lr_mul``, e.g. ``vqa_`` for VQA)."""
    return {n: any(h in n for h in head_paths) for n in names}


MASTER_MIN_SIZE = 2 ** 16  # smallest parameter stored bf16 in master mode
OPTIMS = ("adamw", "adam", "adamax")


class FusedAdamW:
    """One-pass AdamW (or Adam, Adamax) over flat per-group buffers, with
    the optional bf16 parameter storage of master mode (module docstring)
    and, over a process group, data parallelism and the sharded
    parameters of ``--fsdp`` (below).

    ``state()``/``load_state()`` give the moments per parameter name, the
    update count and the last step's pre-clip gradient norm ``gnorm``;
    ``masters()``/``load_masters()`` the fp32 values of the bf16-stored
    parameters; ``state_bytes()`` and ``param_bytes()`` what a rank keeps
    of each.

    Over several processes (``parallel/collectives.py``) each rank holds
    its own gradients of the replicated parameters; a step first sums each
    replicated group's flat gradient over the data group (one all-reduce a
    group: the sum, not the mean, is the contract, reference
    utils/distributed.py:16-43; the data group is the world without a
    model axis). The parameters ``shard`` holds
    (``parallel/fsdp.py``: ``--fsdp``, those whose placement spec names
    ``data``, ``parallel/mesh.py``) are not in ``named_params``: each of
    its groups is held at rest as this rank's block of a padded flat
    buffer, both moments too, and its gradient arrives as that block, from
    the backward's reduce-scatter (JAX ``place_state(fsdp=True)`` and
    ``opt_state_sharding``). A step updates the block in place, in master
    mode the fp32 masters and then their bf16 copy; nothing is gathered
    after it. The norm adds the blocks' sums of squares over the data
    group, so the norm, the clip and every update are the one-process
    ones.

    Under a tensor-parallel model axis (``tp``, the model's
    ``parallel/tp.py`` layout) the parameters are the rank's blocks, each
    a group of its own kind: the sums of squares of the TP-sharded groups
    are also added over the model group, while a replicated parameter,
    whose gradient every model rank holds whole and equal, counts once.
    ``state()``, ``masters()`` and their loads gather and take blocks by
    parameter name over both axes, so a checkpoint does not depend on the
    grid; every rank calls them together. ``state_bytes()`` and
    ``param_bytes()`` stay what this rank keeps."""

    def __init__(self, named_params, learning_rate: Callable | float, *,
                 b1: float = 0.9, b2: float = 0.98, eps: float = 1e-6,
                 weight_decay: float = 0.01,
                 decay: Optional[Dict[str, bool]] = None,
                 grad_norm: float = 0.0, lr_mul: float = 1.0,
                 lr_mul_mask: Optional[Dict[str, bool]] = None,
                 mu_dtype=None, nu_dtype=None, optim: str = "adamw",
                 master: bool = False, shard=None, tp=None):
        from uniter_tpu_torch.parallel.collectives import (
            data_group, model_group)

        if optim not in OPTIMS:
            raise ValueError(f"invalid optimizer {optim}")
        self.optim = optim
        self.lr_fn = (learning_rate if callable(learning_rate)
                      else (lambda _: learning_rate))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_norm = grad_norm or 0.0
        self.count = 0
        self.tp = tp
        self.data_group, self.model_group = data_group(), model_group()
        self.low = []  # (name, bf16 parameter, its fp32 master view)
        named_params = list(named_params)
        device = (named_params[0][1] if named_params
                  else shard.groups[0].block).device
        self.gnorm = torch.zeros((), dtype=torch.float32, device=device)
        groups: Dict[tuple, list] = {}
        for name, p in named_params:
            if p.dtype != torch.float32:
                raise TypeError(f"{name}: parameters are stored fp32")
            groups.setdefault(self.key(name, decay, lr_mul, lr_mul_mask, tp),
                              []).append((name, p))
        self.groups = []
        for (dec, mul, split), members in groups.items():
            n = sum(p.numel() for _, p in members)
            flat = torch.zeros(n, dtype=torch.float32, device=device)
            views, ofs = [], 0
            for name, p in members:
                view = flat[ofs:ofs + p.numel()].view_as(p)
                view.copy_(p.data)
                if master and p.numel() >= MASTER_MIN_SIZE:
                    p.data = view.to(torch.bfloat16)
                    self.low.append((name, p, view))
                else:
                    p.data = view
                views.append((name, p, ofs))
                ofs += p.numel()
            self.groups.append(self._moments(dict(
                decay=dec, mul=mul, flat=flat, params=views, sharded=False,
                split=split, size=n, lo=0, hi=n), mu_dtype, nu_dtype))
        for g in (shard.groups if shard else []):
            dec, mul, split = g.key
            self.groups.append(self._moments(dict(
                decay=dec, mul=mul, flat=g.block.data, shard=g, split=split,
                params=[(name, mod._parameters[attr], ofs)
                        for name, (mod, attr), _, ofs, _ in g.members],
                sharded=True, size=g.size, lo=g.lo, hi=g.hi), mu_dtype,
                nu_dtype))

    @staticmethod
    def key(name, decay, lr_mul, lr_mul_mask, tp=None) -> tuple:
        """A parameter's group: (weight decay applies, lr multiplier,
        TP-sharded)."""
        return ((decay or {}).get(name, True),
                lr_mul if (lr_mul_mask or {}).get(name, False) else 1.0,
                tp is not None and name in tp)

    @staticmethod
    def _moments(group, mu_dtype, nu_dtype):
        n, dev = group["hi"] - group["lo"], group["flat"].device
        group["mu"] = torch.zeros(n, dtype=mu_dtype or torch.float32,
                                  device=dev)
        group["nu"] = torch.zeros(n, dtype=nu_dtype or torch.float32,
                                  device=dev)
        return group

    @staticmethod
    def _flat_grad(group):
        return torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1).float()
                          for _, p, _ in group["params"]])

    @trace.span("optim.step")
    @torch.no_grad()
    def step(self):
        """Apply one update from the parameters' ``.grad`` (a sharded
        group's: its block's) and clear them."""
        from uniter_tpu_torch.parallel.collectives import all_reduce_sum

        grads = []
        for group in self.groups:
            if group["sharded"]:
                block = group["shard"].block
                g = block.grad if block.grad is not None else \
                    torch.zeros_like(block)
                block.grad = None
            else:
                g = all_reduce_sum(self._flat_grad(group), self.data_group)
            grads.append(g)
        squares = [g.square().sum() for g in grads]
        # the blocks' sums over the data group, then the TP-sharded groups'
        # over the model group; a replicated group's counts once
        for kind, comm in (("sharded", self.data_group),
                           ("split", self.model_group)):
            idx = [i for i, group in enumerate(self.groups) if group[kind]]
            if idx:
                summed = all_reduce_sum(torch.stack([squares[i]
                                                     for i in idx]), comm)
                for j, i in enumerate(idx):
                    squares[i] = summed[j]
        gnorm = torch.stack(squares).sum().sqrt()
        if self.grad_norm > 0:
            clip = torch.clamp(self.grad_norm / torch.clamp(
                gnorm, min=self.grad_norm), max=1.0)
        else:
            clip = None
        f32 = np.float32
        lr = f32(self.lr_fn(self.count))
        self.count += 1
        bc1 = f32(1.0) - f32(self.b1) ** f32(self.count)
        bc2 = f32(1.0) - f32(self.b2) ** f32(self.count)
        for group, g in zip(self.groups, grads):
            if clip is not None:
                g.mul_(clip)
            own = group["flat"]
            mu32 = group["mu"].float().mul_(self.b1).add_(g * (1.0 - self.b1))
            if self.optim == "adamax":
                nu32 = torch.maximum(g.abs_().add_(self.eps),
                                     group["nu"].float().mul_(self.b2))
                u = (mu32 / float(bc1)).div_(nu32)
            else:
                nu32 = group["nu"].float().mul_(self.b2).add_(
                    g.square_().mul_(1.0 - self.b2))
                u = (mu32 / float(bc1)).div_(
                    (nu32 / float(bc2)).sqrt_().add_(self.eps))
            if group["decay"]:
                u.add_(own * self.weight_decay)
            own.add_(u.mul_(float(f32(-lr) * f32(group["mul"]))))
            group["mu"].copy_(mu32)
            group["nu"].copy_(nu32)
            if group["sharded"] and group["shard"].low:
                group["shard"].block16.copy_(own)  # one round to nearest
            for _, p, _ in group["params"]:
                p.grad = None
        for _, p, view in self.low:
            p.data.copy_(view)  # one round to nearest even
        self.gnorm = gnorm

    def _full(self, group, buf):
        """A group's whole buffer from the blocks of ``buf`` (moments, or
        the masters)."""
        from uniter_tpu_torch.parallel.collectives import all_gather

        if not group["sharded"]:
            return buf
        return all_gather(torch.empty(group["size"], dtype=buf.dtype,
                                      device=buf.device), buf,
                          self.data_group)

    def _by_name(self, group, full):
        return {name: full[ofs:ofs + p.numel()].view_as(p)
                for name, p, ofs in group["params"]}

    def masters(self) -> Dict[str, torch.Tensor]:
        """The fp32 masters of the bf16-stored parameters, by name (views
        of a replicated group's masters, which the next step updates in
        place; gathered copies for a sharded group or a TP block)."""
        from uniter_tpu_torch.parallel.tp import gather_state

        out = {name: view for name, _, view in self.low}
        for group in self.groups:
            if group["sharded"] and group["shard"].low:
                out.update(self._by_name(group, self._full(group,
                                                           group["flat"])))
        return gather_state(out, self.tp)

    def load_masters(self, weights: Dict[str, torch.Tensor]):
        """Set the masters from fp32 ``weights`` (an export's, every
        parameter's, full tensors) and re-cast their bf16 parameters."""
        from uniter_tpu_torch.parallel.tp import shard_state

        weights = shard_state(weights, self.tp)
        for name, p, view in self.low:
            view.copy_(weights[name])
            p.data.copy_(view)
        for group in self.groups:
            if group["sharded"] and group["shard"].low:
                group["shard"].load(self._assemble(group, weights,
                                                   torch.float32))

    def _assemble(self, group, by_name, dtype):
        full = torch.zeros(group["size"], dtype=dtype,
                           device=group["mu"].device)
        for name, t in self._by_name(group, full).items():
            t.copy_(by_name[name])
        return full

    def state(self) -> dict:
        """Moments by parameter name (storage dtype, full tensors), count
        and gnorm."""
        from uniter_tpu_torch.parallel.tp import gather_state

        mu, nu = {}, {}
        for group in self.groups:
            mu.update(self._by_name(group, self._full(group, group["mu"])))
            nu.update(self._by_name(group, self._full(group, group["nu"])))
        return {"count": self.count, "mu": gather_state(mu, self.tp),
                "nu": gather_state(nu, self.tp), "gnorm": self.gnorm}

    def load_state(self, state: dict):
        from uniter_tpu_torch.parallel.tp import shard_state

        self.count = int(state["count"])
        self.gnorm = state["gnorm"].to(self.gnorm.device, torch.float32)
        moments = {w: shard_state(state[w], self.tp) for w in ("mu", "nu")}
        for group in self.groups:
            for which in ("mu", "nu"):
                full = self._assemble(group, moments[which],
                                      group[which].dtype)
                group[which].copy_(full[group["lo"]:group["hi"]])

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank keeps: both moments and, in
        master mode, the fp32 masters of the bf16-stored parameters (a
        sharded group's block of masters)."""
        n = sum(g["mu"].numel() * g["mu"].element_size()
                + g["nu"].numel() * g["nu"].element_size()
                for g in self.groups)
        n += sum(view.numel() * 4 for _, _, view in self.low)
        n += sum(g["flat"].numel() * 4 for g in self.groups
                 if g["sharded"] and g["shard"].low)
        return n

    def param_bytes(self) -> int:
        """Bytes of parameters this rank holds at rest: every replicated
        parameter's storage, and of a sharded group its block as the
        parameters are stored (bf16 in master mode, else fp32), padding
        included."""
        n = 0
        for g in self.groups:
            if g["sharded"]:
                n += g["shard"].stored_bytes()
            else:
                n += sum(p.numel() * p.element_size()
                         for _, p, _ in g["params"])
        return n


def build_optimizer(model: nn.Module, learning_rate, *, betas=(0.9, 0.98),
                    eps: float = 1e-6, weight_decay: float = 0.01,
                    grad_norm: float = 2.0, lr_mul: float = 1.0,
                    lr_mul_paths: Sequence[str] = (), optim: str = "adamw",
                    mu_dtype=None, nu_dtype=None, fused: bool = False,
                    master: bool = False, fsdp: bool = False,
                    fsdp_min_size: int = 2 ** 16) -> FusedAdamW:
    """Mirror of the JAX package's ``build_optimizer``. The fused and the
    chained AdamW are leaf-exact there (optim.py:90-92), so both are this
    one update; the chain stores only ``mu`` in ``mu_dtype``
    (optax.adamw), as the JAX package's does. ``adam`` and ``adamax`` are
    that package's optax chains (no decay, fp32 moments). ``master`` (bf16
    parameter storage) needs the fused AdamW, as there. ``fsdp`` shards
    the parameters that ``parallel/mesh.py``'s placement shards over the
    process group's ``data`` axis (``fsdp_min_size`` elements or more),
    with their state, at rest (``parallel/fsdp.py``: ZeRO-3). A model
    that ``parallel/tp.py`` ``shard_model`` has cut into TP blocks keeps
    them: the specs are read on its full shapes and the running grid
    (``parallel/mesh.py`` ``current_mesh``), and ``--fsdp`` shards the
    blocks over the data group."""
    from uniter_tpu_torch.parallel.tp import tp_of

    if master and not (fused and optim == "adamw"):
        raise ValueError("master-weight mode (--param_dtype bfloat16) "
                         "requires the fused adamw optimizer")
    params = [(n, p) for n, p in model.named_parameters()]
    names = [n for n, _ in params]
    if optim == "adamw":
        decay = decay_mask(model)
        if not fused:
            nu_dtype = None
    else:
        decay = {n: False for n in names}
        mu_dtype = nu_dtype = None
    mul_mask = (head_mask(names, lr_mul_paths)
                if lr_mul != 1.0 and lr_mul_paths else None)
    replicated, sharding, tp = params, None, tp_of(model)
    if fsdp:
        from uniter_tpu_torch.parallel.fsdp import shard
        from uniter_tpu_torch.parallel.mesh import (
            MeshConfig, current_mesh, sharded_names)

        sizes = {n: p.numel() for n, p in params}
        full = [(n, tp.full_shape(n, p.shape) if tp else p.shape)
                for n, p in params]
        on = sharded_names(full, current_mesh(),
                           MeshConfig(fsdp=True, fsdp_min_size=fsdp_min_size))
        if on:
            sharding = shard(
                model, on, lambda n: FusedAdamW.key(n, decay, lr_mul,
                                                    mul_mask, tp),
                lambda n: master and sizes[n] >= MASTER_MIN_SIZE)
            replicated = [(n, p) for n, p in params if n not in on]
    return FusedAdamW(
        replicated, learning_rate, b1=betas[0], b2=betas[1], eps=eps,
        weight_decay=weight_decay, decay=decay,
        grad_norm=grad_norm or 0.0, lr_mul=lr_mul, lr_mul_mask=mul_mask,
        mu_dtype=mu_dtype, nu_dtype=nu_dtype, optim=optim, master=master,
        shard=sharding, tp=tp)
