"""AdamW as UNITER's recipes run it, in float32 (a frozen copy of the
update, not an import):

    g   = grad * min(1, max_norm / max(|grads|, max_norm))
    mu  = b1 mu + (1 - b1) g;   nu = b2 nu + (1 - b2) g^2
    u   = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p   [decay]
    p  -= lr(t - 1) * lr_mul * u

with the learning rate of the BERT schedule (linear warm-up, then linear
decay; the reference's step counts from 1, floored at 1e-8), read at the
update count before the step.
"""

from __future__ import annotations

from typing import Dict

import torch


def warmup_linear_lr(lr: float, warmup: int, total: int):
    def schedule(count: int) -> float:
        step = count + 1
        if step < warmup:
            f = step / max(warmup, 1)
        else:
            f = max(0.0, (total - step) / max(total - warmup, 1))
        return max(lr * f, 1e-8)
    return schedule


class RefAdamW:
    def __init__(self, params: Dict[str, torch.nn.Parameter], *, lr_fn,
                 betas=(0.9, 0.98), eps=1e-6, weight_decay=0.01,
                 grad_norm=2.0, decay: Dict[str, bool], lr_mul=None):
        self.params = params
        self.lr_fn = lr_fn
        self.b1, self.b2 = betas
        self.eps, self.wd, self.max_norm = eps, weight_decay, grad_norm
        self.decay = decay
        self.lr_mul = lr_mul or {}
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update; returns the gradients it was given (before the
        clip)."""
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.params.items()}
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        clip = 1.0
        if self.max_norm > 0:
            clip = torch.clamp(
                self.max_norm / torch.clamp(norm, min=self.max_norm), max=1.0)
        lr = self.lr_fn(self.count)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for n, p in self.params.items():
            g = grads[n] * clip
            self.mu[n].mul_(self.b1).add_(g * (1.0 - self.b1))
            self.nu[n].mul_(self.b2).add_(g.square() * (1.0 - self.b2))
            u = (self.mu[n] / bc1) / ((self.nu[n] / bc2).sqrt() + self.eps)
            if self.decay[n]:
                u = u + p * self.wd
            p.sub_(u * (lr * self.lr_mul.get(n, 1.0)))
            p.grad = None
        return grads
