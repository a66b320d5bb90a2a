"""UNITER in plain PyTorch: the trunk, the VQA and pretraining heads and
losses, the plain IPOT, and the retrieval scorer's arithmetic.

Written from the UNITER paper (arXiv:1909.11740) and ChenRocks/UNITER's
model/model.py, model/layer.py, model/pretrain.py, model/vqa.py and
model/ot.py, in float32 with no kernel, cache or batching trick. It
imports nothing of the program under test. Parameter names are the
released checkpoints' (``uniter.encoder.layer.3.attention.self.query
.weight``), so one state dict loads into both.

The layout is the program's fixed one: the joint sequence is [txt (T,
CLS at 0, padded) ; img (R, padded)], padding masked by an additive
-10000 on the keys. Dropout (the rate of the configuration) sits where
the published model has it: after each embedding LayerNorm, on the
attention probabilities, and before each sub-block's residual LayerNorm.
Its masks are those of ``philox`` for the seeds ``StepSeeds`` gives.

``Numerics`` is how products are computed: float32 with TF32 off, or the
control's float8 (e4m3, one scale a tensor) operands.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gpubench.reference.philox import keep_mask

MASK_VALUE = -10000.0
E4M3_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class RefConfig:
    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    intermediate_size: int
    max_position_embeddings: int
    type_vocab_size: int
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    img_dim: int = 2048
    img_label_dim: int = 1601

    @classmethod
    def from_dict(cls, d: dict, **kw) -> "RefConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{**{k: v for k, v in d.items() if k in names}, **kw})


class Numerics:
    """Float32 (``fp8=False``), or the control: every tensor the forward
    makes (the products' operands and results, the embeddings, the
    LayerNorm, GELU, softmax, dropout and residual outputs) rounded to
    float8 e4m3, each scaled by its largest magnitude, as the program rounds
    them to bf16. The rounding passes gradients straight through, so the
    backward's products take the rounded operands the forward saved."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        with torch.no_grad():
            scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
            low = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (low - x).detach()

    def lin(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def einsum(self, eq, a, b):
        return self.q(torch.einsum(eq, self.q(a), self.q(b)))


def gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def ln(x, mod: nn.LayerNorm):
    return F.layer_norm(x, x.shape[-1:], mod.weight, mod.bias, mod.eps)


def _module(**children) -> nn.Module:
    m = nn.Module()
    for k, v in children.items():
        setattr(m, k, v)
    return m


def _lin(i, o):
    return nn.Linear(i, o)


def _ln(n, eps):
    return nn.LayerNorm(n, eps=eps)


def build_trunk(cfg: RefConfig) -> nn.Module:
    h, eps = cfg.hidden_size, cfg.layer_norm_eps
    layers = nn.ModuleList()
    for _ in range(cfg.num_hidden_layers):
        layers.append(_module(
            attention=_module(
                self=_module(query=_lin(h, h), key=_lin(h, h),
                             value=_lin(h, h)),
                output=_module(dense=_lin(h, h), LayerNorm=_ln(h, eps))),
            intermediate=_module(dense=_lin(h, cfg.intermediate_size)),
            output=_module(dense=_lin(cfg.intermediate_size, h),
                           LayerNorm=_ln(h, eps))))
    return _module(
        embeddings=_module(
            word_embeddings=nn.Embedding(cfg.vocab_size, h),
            position_embeddings=nn.Embedding(cfg.max_position_embeddings, h),
            token_type_embeddings=nn.Embedding(cfg.type_vocab_size, h),
            LayerNorm=_ln(h, eps)),
        img_embeddings=_module(
            img_linear=_lin(cfg.img_dim, h), img_layer_norm=_ln(h, eps),
            pos_linear=_lin(7, h), pos_layer_norm=_ln(h, eps),
            mask_embedding=nn.Embedding(2, cfg.img_dim),
            LayerNorm=_ln(h, eps)),
        encoder=_module(layer=layers),
        pooler=_module(dense=_lin(h, h)))


class RefModel(nn.Module):
    """The trunk ``uniter`` and the heads of ``heads``: "vqa" (with
    ``num_answer``), "pretrain" (MLM, MRFR, MRC, ITM), "itm" (retrieval's
    ITM and rank heads), or none."""

    def __init__(self, cfg: RefConfig, heads: str = "", num_answer: int = 0):
        super().__init__()
        self.cfg = cfg
        self.uniter = build_trunk(cfg)
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        if heads == "vqa":
            self.vqa_output = nn.Sequential(_lin(h, 2 * h), nn.GELU(),
                                            _ln(2 * h, eps),
                                            _lin(2 * h, num_answer))
        elif heads == "pretrain":
            self.cls = _module(predictions=_module(
                transform=_module(dense=_lin(h, h), LayerNorm=_ln(h, eps)),
                bias=nn.Parameter(torch.zeros(cfg.vocab_size))))
            self.feat_regress = _module(
                net=nn.Sequential(_lin(h, h), nn.GELU(), _ln(h, eps)),
                bias=nn.Parameter(torch.zeros(cfg.img_dim)))
            self.region_classifier = _module(net=nn.Sequential(
                _lin(h, h), nn.GELU(), _ln(h, eps),
                _lin(h, cfg.img_label_dim)))
            self.itm_output = _lin(h, 2)
        elif heads == "itm":
            self.itm_output = _lin(h, 2)
            self.rank_output = _lin(h, 1)
        elif heads:
            raise ValueError(f"unknown heads {heads!r}")


def init_kind(model: nn.Module) -> Dict[str, str]:
    """Each parameter's initial value as the published model draws it:
    "normal" (linear weights, embedding tables), "ones" (LayerNorm
    weights) or "zeros" (biases)."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            if pname == "bias":
                out[key] = "zeros"
            elif isinstance(mod, nn.LayerNorm):
                out[key] = "ones"
            else:
                out[key] = "normal"
    return out


def decays(model: nn.Module) -> Dict[str, bool]:
    """AdamW's weight decay: linear weights and embedding tables only."""
    return {n: k == "normal" for n, k in init_kind(model).items()}


class Forward:
    """The model's forward on a batch of tensors, with dropout masks from
    ``seeds`` (a ``StepSeeds``, or None for no dropout)."""

    def __init__(self, model: RefModel, numerics: Optional[Numerics] = None):
        self.m = model
        self.cfg = model.cfg
        self.nx = numerics or Numerics()

    def _drop(self, x, rate, seeds):
        if seeds is None or rate == 0.0:
            return x
        keep = keep_mask(seeds.next(), x.shape, rate, x.device)
        return self.nx.q(torch.where(keep, x / (1.0 - rate),
                                     torch.zeros_like(x)))

    def _ln(self, x, mod):
        return self.nx.q(ln(self.nx.q(x), mod))

    def _gelu(self, x):
        return self.nx.q(gelu(x))

    def _lin(self, x, mod):
        return self.nx.lin(x, mod.weight, mod.bias)

    def embed(self, b, seeds):
        u, cfg = self.m.uniter, self.cfg
        e = u.embeddings
        rate = cfg.hidden_dropout_prob
        ids = b["input_ids"].long()
        txt = (e.word_embeddings.weight[ids]
               + e.position_embeddings.weight[b["position_ids"].long()]
               + e.token_type_embeddings.weight[0])
        txt = self._drop(self._ln(txt, e.LayerNorm), rate, seeds)
        ie = u.img_embeddings
        feat = b["img_feat"].float()
        if b.get("img_masks") is not None:
            feat = feat + b["img_masks"].bool()[..., None].float() \
                * ie.mask_embedding.weight[1]
        im = self._ln(self._lin(feat, ie.img_linear), ie.img_layer_norm)
        pos = self._ln(self._lin(b["img_pos_feat"].float(), ie.pos_linear),
                       ie.pos_layer_norm)
        img = self._ln(im + pos + e.token_type_embeddings.weight[1],
                       ie.LayerNorm)
        img = self._drop(img, rate, seeds)
        return torch.cat([txt, img], dim=1)

    def attention(self, x, bias, sa, seed_rate, q_rows=None):
        cfg = self.cfg
        bsz, s, hid = x.shape
        nh = cfg.num_attention_heads
        d = hid // nh
        xq = x if q_rows is None else x[:, :q_rows]
        q = self._lin(xq, sa.query).view(bsz, xq.shape[1], nh, d)
        k = self._lin(x, sa.key).view(bsz, s, nh, d)
        v = self._lin(x, sa.value).view(bsz, s, nh, d)
        scores = self.nx.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
        p = self.nx.q(torch.softmax(scores + bias[:, None, None, :],
                                    dim=-1))
        if seed_rate is not None:
            seed, rate = seed_rate
            keep = keep_mask(seed, p.shape, rate, p.device)
            p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
        return self.nx.einsum("bhqk,bkhd->bqhd", p, v).reshape(
            bsz, xq.shape[1], hid)

    def layer(self, h, bias, lyr, seeds):
        cfg = self.cfg
        live = seeds is not None
        a_seed = (seeds.next(), cfg.attention_probs_dropout_prob) \
            if live else None
        ctx = self.attention(h, bias, lyr.attention.self, a_seed)
        ao = lyr.attention.output
        a = self._ln(self._drop(self._lin(ctx, ao.dense),
                          cfg.hidden_dropout_prob, seeds) + h, ao.LayerNorm)
        f = self._lin(self._gelu(self._lin(a, lyr.intermediate.dense)),
                      lyr.output.dense)
        return self._ln(self._drop(f, cfg.hidden_dropout_prob, seeds) + a,
                  lyr.output.LayerNorm)

    def trunk(self, b, seeds=None):
        h = self.embed(b, seeds)
        bias = (1.0 - b["attn_mask"].float()) * MASK_VALUE
        for lyr in self.m.uniter.encoder.layer:
            h = self.layer(h, bias, lyr, seeds)
        return h

    def pooled(self, h):
        return self.nx.q(torch.tanh(self._lin(h[:, 0],
                                              self.m.uniter.pooler.dense)))

    # ---- VQA --------------------------------------------------------------
    def vqa_loss(self, b, seeds=None):
        """bce.mean() * num_answer over the rows ``ex_weight`` marks."""
        head = self.m.vqa_output
        x = self._gelu(self._lin(self.pooled(self.trunk(b, seeds)), head[0]))
        logits = self._lin(self._ln(x, head[2]), head[3])
        t = b["targets"].float()
        bce = logits.clamp_min(0) - logits * t + torch.log1p(
            torch.exp(-logits.abs()))
        w = b["ex_weight"].float()[:, None]
        return (bce * w).sum() / w.sum().clamp_min(1.0)

    # ---- pretraining --------------------------------------------------------
    @staticmethod
    def _gather(seq, pos):
        return torch.gather(seq, 1, pos.long()[..., None].expand(
            -1, -1, seq.shape[-1]))

    def _transform(self, x, net):
        return self._ln(self._gelu(self._lin(x, net[0])), net[2])

    def pretrain_loss(self, b, task: str, seeds=None, ot_lambda=0.1):
        m = self.m
        h = self.trunk(b, seeds)
        t = b["input_ids"].shape[1]
        if task == "mlm":
            tr = m.cls.predictions.transform
            x = self._ln(self._gelu(self._lin(
                self._gather(h[:, :t], b["mlm_pos"]), tr.dense)),
                tr.LayerNorm)
            logits = self.nx.lin(x, m.uniter.embeddings.word_embeddings
                                 .weight, m.cls.predictions.bias)
            tgt = b["mlm_tgt"].long()
            valid = (tgt != -1).float()
            nll = -torch.log_softmax(logits, -1).gather(
                -1, tgt.clamp_min(0)[..., None])[..., 0]
            return (nll * valid).sum() / valid.sum().clamp_min(1.0)
        if task == "mrfr":
            x = self._transform(self._gather(h[:, t:], b["mrm_pos"]),
                                m.feat_regress.net)
            pred = self.nx.lin(x, m.uniter.img_embeddings.img_linear.weight
                               .t(), m.feat_regress.bias)
            w = b["mrm_valid"].float()[..., None].expand_as(pred)
            err = (pred - b["feat_targets"].float()).square() * w
            return err.sum() / w.sum().clamp_min(1.0)
        if task.startswith("mrc"):
            net = m.region_classifier.net
            x = self._transform(self._gather(h[:, t:], b["mrm_pos"]), net)
            logp = torch.log_softmax(self._lin(x, net[3]), -1)
            tgt = b["label_targets"].float()
            valid = b["mrm_valid"].float()[..., None]
            kl = torch.where(tgt > 0, tgt * (torch.log(tgt.clamp_min(1e-12))
                                             - logp), torch.zeros_like(tgt))
            w = valid.expand_as(kl)
            return (kl * w).sum() / w.sum().clamp_min(1.0)
        if task == "itm":
            logits = self._lin(self.pooled(h), m.itm_output)
            tgt = b["targets"].long()
            valid = (tgt != -1).float()
            nll = -torch.log_softmax(logits, -1).gather(
                -1, tgt.clamp_min(0)[..., None])[..., 0]
            loss = (nll * valid).sum() / valid.sum().clamp_min(1.0)
            if not ot_lambda:
                return loss
            attn = b["attn_mask"].bool()
            dist = ot_distance(h[:, :t], h[:, t:], ~attn[:, :t], ~attn[:, t:],
                               self.nx)
            pos, neg = (tgt == 1).float(), (tgt == 0).float()
            ot = ((dist * pos).sum() - (dist * neg).sum()) / (
                pos.sum() + neg.sum()).clamp_min(1.0)
            return loss + ot_lambda * ot
        raise ValueError(f"unknown task {task!r}")

    # ---- retrieval scoring -------------------------------------------------
    def cls_scores(self, b, rank_head) -> torch.Tensor:
        """The ITM match logit of each row: the trunk without dropout, its
        last layer read at the CLS row, the pooler and ``rank_head``."""
        h = self.embed(b, None)
        bias = (1.0 - b["attn_mask"].float()) * MASK_VALUE
        layers = self.m.uniter.encoder.layer
        for lyr in layers[:-1]:
            h = self.layer(h, bias, lyr, None)
        last = layers[-1]
        ctx = self.attention(h, bias, last.attention.self, None, q_rows=1)
        ao = last.attention.output
        a = self._ln(self._lin(ctx, ao.dense) + h[:, :1], ao.LayerNorm)
        f = self._lin(self._gelu(self._lin(a, last.intermediate.dense)),
                      last.output.dense)
        out = self._ln(f + a, last.output.LayerNorm)
        return self._lin(self.pooled(out), rank_head)[:, 0]


def ipot(C, x_len, x_pad, y_len, y_pad, joint_pad, beta=0.5, iteration=50,
         k=1):
    """Inexact proximal point OT (ChenRocks/UNITER model/ot.py), [B, M, N]
    cost to the [B, N, M] plan, zero at joint padding."""
    x_len = x_len.float().clamp_min(1.0)[:, None]
    y_len = y_len.float().clamp_min(1.0)[:, None]
    jp = joint_pad.transpose(1, 2)
    A = torch.where(jp, torch.zeros_like(C.transpose(1, 2)),
                    torch.exp(-C.transpose(1, 2) / beta))
    sigma = torch.where(x_pad, torch.zeros_like(x_pad, dtype=C.dtype),
                        1.0 / x_len)
    x_mask, y_mask = x_pad.float() * 1e4, y_pad.float() * 1e4
    T = (~jp).float()
    for _ in range(iteration):
        Q = A * T
        for _ in range(k):
            delta = 1.0 / (y_len * torch.einsum("bnm,bm->bn", Q, sigma)
                           + y_mask)
            sigma = 1.0 / (x_len * torch.einsum("bn,bnm->bm", delta, Q)
                           + x_mask)
        T = delta[:, :, None] * Q * sigma[:, None, :]
    return torch.where(jp, torch.zeros_like(T), T)


def ot_distance(txt, img, txt_pad, img_pad, nx: Numerics):
    """The WRA distance of each row: trace(C T) on the cosine cost, the
    plan from ``ipot`` without gradient."""
    xn = txt / txt.norm(dim=-1, keepdim=True).clamp_min(1e-5)
    yn = img / img.norm(dim=-1, keepdim=True).clamp_min(1e-5)
    cost = 1.0 - nx.einsum("bmd,bnd->bmn", xn, yn)
    joint = txt_pad[:, :, None] | img_pad[:, None, :]
    cost = cost.masked_fill(joint, 0.0)
    with torch.no_grad():
        plan = ipot(cost.detach(), (~txt_pad).sum(1), txt_pad,
                    (~img_pad).sum(1), img_pad, joint)
    return torch.einsum("bmn,bnm->b", cost, plan)
