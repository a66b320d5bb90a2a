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
    and, over a process group, data parallelism and the sharded state of
    ``--fsdp`` (below).

    ``state()``/``load_state()`` give the moments per parameter name, the
    update count and the last step's pre-clip gradient norm ``gnorm``;
    ``masters()``/``load_masters()`` the fp32 values of the bf16-stored
    parameters.

    Over several processes (``parallel/collectives.py``) each rank holds
    its own gradients; a step first sums each group's flat gradient over
    the ranks (one all-reduce a group: the sum, not the mean, is the
    contract, reference utils/distributed.py:16-43), so the norm, the clip
    and the update are the same on every rank. The parameters named in
    ``shard`` (``--fsdp``: those whose placement spec names ``data``,
    ``parallel/mesh.py``) form groups of their own whose flat buffer is
    padded to a multiple of the world size; each rank keeps only its block
    of both moments (and, in master mode, of the fp32 masters), takes its
    block of the summed gradient by a reduce-scatter, updates it and
    all-gathers the parameters (JAX ``place_state(fsdp=True)`` and
    ``opt_state_sharding``). The norm adds the blocks' sums of squares
    over the ranks. The full parameters stay on every rank. ``state()``,
    ``masters()`` and their loads gather and take blocks by parameter
    name, so a checkpoint does not depend on the world size; every rank
    calls them together."""

    def __init__(self, named_params, learning_rate: Callable | float, *,
                 b1: float = 0.9, b2: float = 0.98, eps: float = 1e-6,
                 weight_decay: float = 0.01,
                 decay: Optional[Dict[str, bool]] = None,
                 grad_norm: float = 0.0, lr_mul: float = 1.0,
                 lr_mul_mask: Optional[Dict[str, bool]] = None,
                 mu_dtype=None, nu_dtype=None, optim: str = "adamw",
                 master: bool = False, shard: Iterable[str] = ()):
        from uniter_tpu_torch.parallel.collectives import (
            num_processes, process_index)

        if optim not in OPTIMS:
            raise ValueError(f"invalid optimizer {optim}")
        self.optim = optim
        self.lr_fn = (learning_rate if callable(learning_rate)
                      else (lambda _: learning_rate))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_norm = grad_norm or 0.0
        self.count = 0
        self.low = []  # (name, bf16 parameter, its fp32 master view)
        named_params = list(named_params)
        device = named_params[0][1].device
        self.gnorm = torch.zeros((), dtype=torch.float32, device=device)
        world, rank = num_processes(), process_index()
        shard = set(shard)
        groups: Dict[tuple, list] = {}
        for name, p in named_params:
            if p.dtype != torch.float32:
                raise TypeError(f"{name}: parameters are stored fp32")
            key = ((decay or {}).get(name, True),
                   lr_mul if (lr_mul_mask or {}).get(name, False) else 1.0,
                   name in shard)
            groups.setdefault(key, []).append((name, p))
        self.groups = []
        for (dec, mul, sharded), members in groups.items():
            n = sum(p.numel() for _, p in members)
            size = -(-n // world) * world if sharded else n
            lo, hi = (rank * size // world, (rank + 1) * size // world) \
                if sharded else (0, n)
            full = torch.zeros(size, dtype=torch.float32, device=device)
            views, ofs = [], 0
            for name, p in members:
                view = full[ofs:ofs + p.numel()].view_as(p)
                view.copy_(p.data)
                if master and p.numel() >= MASTER_MIN_SIZE:
                    p.data = view.to(torch.bfloat16)
                    if not sharded:
                        self.low.append((name, p, view))
                elif master and sharded:
                    p.data = view.clone()  # the masters are a block only
                else:
                    p.data = view
                views.append((name, p, ofs))
                ofs += p.numel()
            # ``flat``: the fp32 values this rank updates (all of them, or
            # its block, which in master mode is all it keeps)
            flat = full[lo:hi].clone() if (master and sharded) else full
            mu = torch.zeros(hi - lo, dtype=mu_dtype or torch.float32,
                             device=device)
            nu = torch.zeros(hi - lo, dtype=nu_dtype or torch.float32,
                             device=device)
            self.groups.append(dict(decay=dec, mul=mul, flat=flat, mu=mu,
                                    nu=nu, params=views, sharded=sharded,
                                    size=size, lo=lo, hi=hi,
                                    master=master and sharded))

    @staticmethod
    def _flat_grad(group):
        grads = [(p.grad if p.grad is not None else torch.zeros_like(p))
                 .reshape(-1).float() for _, p, _ in group["params"]]
        pad = group["size"] - sum(p.numel() for _, p, _ in group["params"])
        if pad:
            grads.append(grads[0].new_zeros(pad))
        return torch.cat(grads)

    def _own(self, group):
        """The fp32 values this rank updates: ``flat`` or its block."""
        if group["sharded"] and not group["master"]:
            return group["flat"][group["lo"]:group["hi"]]
        return group["flat"]

    def _gather_params(self, group):
        """After an update of a sharded group, every rank's parameters
        from the blocks of all."""
        from uniter_tpu_torch.parallel.collectives import all_gather

        if not group["master"]:
            all_gather(group["flat"], self._own(group).clone())
            return
        full = all_gather(torch.empty(group["size"], dtype=torch.float32,
                                      device=group["flat"].device),
                          group["flat"])
        for _, p, ofs in group["params"]:
            # bf16 parameters: one round to nearest even
            p.data.copy_(full[ofs:ofs + p.numel()].view_as(p))

    @torch.no_grad()
    def step(self):
        """Apply one update from the parameters' ``.grad`` and clear them."""
        from uniter_tpu_torch.parallel.collectives import (
            all_reduce_sum, reduce_scatter)

        grads = []
        for group in self.groups:
            g = self._flat_grad(group)
            if group["sharded"]:
                g = reduce_scatter(torch.empty_like(group["mu"],
                                                    dtype=torch.float32), g)
            else:
                g = all_reduce_sum(g)
            grads.append(g)
        squares = [g.square().sum() for g in grads]
        blocks = [i for i, group in enumerate(self.groups)
                  if group["sharded"]]
        if blocks:
            summed = all_reduce_sum(torch.stack([squares[i]
                                                 for i in blocks]))
            for j, i in enumerate(blocks):
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
            own = self._own(group)
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
            if group["sharded"]:
                self._gather_params(group)
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
                                      device=buf.device), buf)

    def _by_name(self, group, full):
        return {name: full[ofs:ofs + p.numel()].view_as(p)
                for name, p, ofs in group["params"]}

    def masters(self) -> Dict[str, torch.Tensor]:
        """The fp32 masters of the bf16-stored parameters, by name (views
        of a replicated group's masters, which the next step updates in
        place; gathered copies for a sharded group)."""
        out = {name: view for name, _, view in self.low}
        for group in self.groups:
            if group["master"]:
                full = self._by_name(group, self._full(group, group["flat"]))
                out.update({name: full[name] for name, p, _ in
                            group["params"] if p.dtype == torch.bfloat16})
        return out

    def load_masters(self, weights: Dict[str, torch.Tensor]):
        """Set the masters from fp32 ``weights`` (an export's, every
        parameter's) and re-cast their bf16 parameters."""
        for name, p, view in self.low:
            view.copy_(weights[name])
            p.data.copy_(view)
        for group in self.groups:
            if group["master"]:
                full = self._assemble(group, weights, torch.float32)
                group["flat"].copy_(full[group["lo"]:group["hi"]])
                for name, p, ofs in group["params"]:
                    p.data.copy_(full[ofs:ofs + p.numel()].view_as(p))

    def _assemble(self, group, by_name, dtype):
        full = torch.zeros(group["size"], dtype=dtype,
                           device=group["mu"].device)
        for name, t in self._by_name(group, full).items():
            t.copy_(by_name[name])
        return full

    def state(self) -> dict:
        """Moments by parameter name (storage dtype), count and gnorm."""
        mu, nu = {}, {}
        for group in self.groups:
            mu.update(self._by_name(group, self._full(group, group["mu"])))
            nu.update(self._by_name(group, self._full(group, group["nu"])))
        return {"count": self.count, "mu": mu, "nu": nu, "gnorm": self.gnorm}

    def load_state(self, state: dict):
        self.count = int(state["count"])
        self.gnorm = state["gnorm"].to(self.gnorm.device, torch.float32)
        for group in self.groups:
            for which in ("mu", "nu"):
                full = self._assemble(group, state[which],
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
        n += sum(g["flat"].numel() * 4 for g in self.groups if g["master"])
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
    the state of the parameters that ``parallel/mesh.py``'s placement
    shards over the process group's ``data`` axis (``fsdp_min_size``
    elements or more)."""
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
    shard = ()
    if fsdp:
        from uniter_tpu_torch.parallel.mesh import (
            MeshConfig, make_mesh, sharded_names)

        shard = sharded_names([(n, p.shape) for n, p in params], make_mesh(),
                              MeshConfig(fsdp=True,
                                         fsdp_min_size=fsdp_min_size))
    return FusedAdamW(
        params, learning_rate, b1=betas[0], b2=betas[1], eps=eps,
        weight_decay=weight_decay, decay=decay,
        grad_norm=grad_norm or 0.0, lr_mul=lr_mul,
        lr_mul_mask=(head_mask(names, lr_mul_paths)
                     if lr_mul != 1.0 and lr_mul_paths else None),
        mu_dtype=mu_dtype, nu_dtype=nu_dtype, optim=optim, master=master,
        shard=shard)
