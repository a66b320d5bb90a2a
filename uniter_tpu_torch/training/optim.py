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
    the optional bf16 parameter storage of master mode (module docstring).

    ``state()``/``load_state()`` give the moments per parameter name, the
    update count and the last step's pre-clip gradient norm ``gnorm``;
    ``masters()``/``load_masters()`` the fp32 values of the bf16-stored
    parameters."""

    def __init__(self, named_params, learning_rate: Callable | float, *,
                 b1: float = 0.9, b2: float = 0.98, eps: float = 1e-6,
                 weight_decay: float = 0.01,
                 decay: Optional[Dict[str, bool]] = None,
                 grad_norm: float = 0.0, lr_mul: float = 1.0,
                 lr_mul_mask: Optional[Dict[str, bool]] = None,
                 mu_dtype=None, nu_dtype=None, optim: str = "adamw",
                 master: bool = False):
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
        groups: Dict[tuple, list] = {}
        for name, p in named_params:
            if p.dtype != torch.float32:
                raise TypeError(f"{name}: parameters are stored fp32")
            key = ((decay or {}).get(name, True),
                   lr_mul if (lr_mul_mask or {}).get(name, False) else 1.0)
            groups.setdefault(key, []).append((name, p))
        self.groups = []
        for (dec, mul), members in groups.items():
            n = sum(p.numel() for _, p in members)
            flat = torch.empty(n, dtype=torch.float32, device=device)
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
            mu = torch.zeros(n, dtype=mu_dtype or torch.float32,
                             device=device)
            nu = torch.zeros(n, dtype=nu_dtype or torch.float32,
                             device=device)
            self.groups.append(dict(decay=dec, mul=mul, flat=flat, mu=mu,
                                    nu=nu, params=views))

    @staticmethod
    def _flat_grad(group):
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .reshape(-1).float() for _, p, _ in group["params"]])

    @torch.no_grad()
    def step(self):
        """Apply one update from the parameters' ``.grad`` and clear them."""
        grads = [self._flat_grad(g) for g in self.groups]
        gnorm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
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
                u.add_(group["flat"] * self.weight_decay)
            group["flat"].add_(u.mul_(float(f32(-lr) * f32(group["mul"]))))
            group["mu"].copy_(mu32)
            group["nu"].copy_(nu32)
            for _, p, _ in group["params"]:
                p.grad = None
        for _, p, view in self.low:
            p.data.copy_(view)  # one round to nearest even
        self.gnorm = gnorm

    def masters(self) -> Dict[str, torch.Tensor]:
        """The fp32 masters of the bf16-stored parameters, by name (views:
        the next step updates them in place)."""
        return {name: view for name, _, view in self.low}

    def load_masters(self, weights: Dict[str, torch.Tensor]):
        """Set the masters from fp32 ``weights`` (an export's) and re-cast
        their bf16 parameters."""
        for name, p, view in self.low:
            view.copy_(weights[name])
            p.data.copy_(view)

    def state(self) -> dict:
        """Moments by parameter name (storage dtype), count and gnorm."""
        mu, nu = {}, {}
        for group in self.groups:
            for name, p, ofs in group["params"]:
                n = p.numel()
                mu[name] = group["mu"][ofs:ofs + n].view_as(p)
                nu[name] = group["nu"][ofs:ofs + n].view_as(p)
        return {"count": self.count, "mu": mu, "nu": nu, "gnorm": self.gnorm}

    def load_state(self, state: dict):
        self.count = int(state["count"])
        self.gnorm = state["gnorm"].to(self.gnorm.device, torch.float32)
        mine = self.state()
        for which in ("mu", "nu"):
            for name, t in mine[which].items():
                t.copy_(state[which][name])


def build_optimizer(model: nn.Module, learning_rate, *, betas=(0.9, 0.98),
                    eps: float = 1e-6, weight_decay: float = 0.01,
                    grad_norm: float = 2.0, lr_mul: float = 1.0,
                    lr_mul_paths: Sequence[str] = (), optim: str = "adamw",
                    mu_dtype=None, nu_dtype=None, fused: bool = False,
                    master: bool = False) -> FusedAdamW:
    """Mirror of the JAX package's ``build_optimizer``. The fused and the
    chained AdamW are leaf-exact there (optim.py:90-92), so both are this
    one update; the chain stores only ``mu`` in ``mu_dtype``
    (optax.adamw), as the JAX package's does. ``adam`` and ``adamax`` are
    that package's optax chains (no decay, fp32 moments). ``master`` (bf16
    parameter storage) needs the fused AdamW, as there."""
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
    return FusedAdamW(
        params, learning_rate, b1=betas[0], b2=betas[1], eps=eps,
        weight_decay=weight_decay, decay=decay,
        grad_norm=grad_norm or 0.0, lr_mul=lr_mul,
        lr_mul_mask=(head_mask(names, lr_mul_paths)
                     if lr_mul != 1.0 and lr_mul_paths else None),
        mu_dtype=mu_dtype, nu_dtype=nu_dtype, optim=optim, master=master)
