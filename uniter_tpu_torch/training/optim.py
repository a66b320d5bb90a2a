"""AdamW as the JAX package computes it (counterpart of
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

On the card the optimizer step is bound by memory traffic, so parameters
live in a few flat fp32 buffers, one per (decay, lr_mul) group, and each
``nn.Parameter``'s data becomes a view into its group's buffer; the
gradients are gathered into one flat buffer per group. A step is then a
dozen elementwise passes over each group, not a dozen per parameter.
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


class FusedAdamW:
    """One-pass AdamW over flat per-group buffers (module docstring).

    ``state()``/``load_state()`` give the moments per parameter name, the
    update count and the last step's pre-clip gradient norm ``gnorm``."""

    def __init__(self, named_params, learning_rate: Callable | float, *,
                 b1: float = 0.9, b2: float = 0.98, eps: float = 1e-6,
                 weight_decay: float = 0.01,
                 decay: Optional[Dict[str, bool]] = None,
                 grad_norm: float = 0.0, lr_mul: float = 1.0,
                 lr_mul_mask: Optional[Dict[str, bool]] = None,
                 mu_dtype=None, nu_dtype=None):
        self.lr_fn = (learning_rate if callable(learning_rate)
                      else (lambda _: learning_rate))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_norm = grad_norm or 0.0
        self.count = 0
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
        self.gnorm = gnorm

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
    """Mirror of the JAX package's ``build_optimizer`` for ``adamw``. The
    fused and the chained AdamW are leaf-exact there (optim.py:90-92), so
    both are this one update; the chain stores only ``mu`` in ``mu_dtype``
    (optax.adamw), as the JAX package's does. ``adam``, ``adamax`` and
    ``master`` mode (bf16 parameter storage) are not ported."""
    if optim != "adamw":
        raise NotImplementedError(
            f"optimizer {optim!r} is not ported; use adamw")
    if master:
        raise NotImplementedError(
            "master-weight mode (--param_dtype bfloat16) is not ported")
    params = [(n, p) for n, p in model.named_parameters()]
    names = [n for n, _ in params]
    return FusedAdamW(
        params, learning_rate, b1=betas[0], b2=betas[1], eps=eps,
        weight_decay=weight_decay, decay=decay_mask(model),
        grad_norm=grad_norm or 0.0, lr_mul=lr_mul,
        lr_mul_mask=(head_mask(names, lr_mul_paths)
                     if lr_mul != 1.0 and lr_mul_paths else None),
        mu_dtype=mu_dtype, nu_dtype=nu_dtype if fused else None)
