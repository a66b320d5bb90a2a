"""Task heads and auxiliary attention blocks (counterpart of
``uniter_tpu/models/heads.py``): the pretraining heads
``BertPredictionHeadTransform`` / ``MLMHead`` (reference
model/layer.py:188-233), ``RegionFeatureRegression`` /
``RegionClassification`` (model/pretrain.py:19-47), the attention pooling
of reference model/nlvr2.py:110-125 and the torch-style MultiheadAttention
of reference model/attention.py:268-402, which NLVR2's paired-attn model
runs across its two streams (model/nlvr2.py:184-191).

Parameters are named after the reference ``.pt`` keys
(``predictions.transform.dense.*``, ``predictions.bias``, ``net.0.*``,
``attn_pool.fc.0.*``, ``attn1.in_proj_weight``, ``attn1.out_proj.*``), so
the weight bridge's state dicts load with ``strict=True``. The MLM decoder
and the MRFR projection are tied: they take the word table and
``img_linear``'s weight at call time and register no parameter of their
own. Dropout draws its seeds from the step's generator, as the trunk's
does.
"""

from __future__ import annotations

import torch
from torch import nn

from uniter_tpu_torch.config import UniterConfig
from uniter_tpu_torch.models.encoder import MASK_VALUE, LayerNorm, Linear
from uniter_tpu_torch.ops.activations import ACT2FN, gelu
from uniter_tpu_torch.ops.attention import multi_head_attention
from uniter_tpu_torch.ops.dropout import (
    batch_block, dropout, live_seed, rows_before)


class GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


class BertPredictionHeadTransform(nn.Module):
    """Dense -> act -> LN (reference model/layer.py:188-202)."""

    def __init__(self, cfg: UniterConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.act = ACT2FN[cfg.hidden_act]
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                   cfg.layer_norm_impl)

    def forward(self, x):
        return self.LayerNorm(self.act(self.dense(x)))


class BertLMPredictionHead(nn.Module):
    """Vocabulary logits with the decoder tied to the word-embedding table
    (reference model/layer.py:205-222): ``table`` [V, H] is
    ``uniter.embeddings.word_embeddings.weight``, passed at call time."""

    def __init__(self, cfg: UniterConfig):
        super().__init__()
        self.transform = BertPredictionHeadTransform(cfg)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, x, table):
        h = self.transform(x)
        return torch.nn.functional.linear(h, table.to(h.dtype),
                                          self.bias.to(h.dtype))


class MLMHead(nn.Module):
    """The reference's ``BertOnlyMLMHead`` (model/layer.py:225-233): its
    keys are ``cls.predictions.*``."""

    def __init__(self, cfg: UniterConfig):
        super().__init__()
        self.predictions = BertLMPredictionHead(cfg)

    def forward(self, x, table):
        return self.predictions(x, table)


class RegionFeatureRegression(nn.Module):
    """MRFR head: Dense + GELU + LN, then the projection back to feature
    space with ``img_linear``'s weight [H, feat_dim], passed at call time
    (reference model/pretrain.py:19-33)."""

    def __init__(self, cfg: UniterConfig, feat_dim: int = 2048):
        super().__init__()
        h = cfg.hidden_size
        self.net = nn.Sequential(
            Linear(h, h), GELU(),
            LayerNorm(h, cfg.layer_norm_eps, cfg.layer_norm_impl))
        self.bias = nn.Parameter(torch.zeros(feat_dim))

    def forward(self, x, img_linear_weight):
        h = self.net(x)
        return torch.nn.functional.linear(
            h, img_linear_weight.t().to(h.dtype), self.bias.to(h.dtype))


class RegionClassification(nn.Module):
    """MRC head: Dense + GELU + LN + Dense(label_dim) (reference
    model/pretrain.py:36-47)."""

    def __init__(self, cfg: UniterConfig, label_dim: int = 1601):
        super().__init__()
        h = cfg.hidden_size
        self.net = nn.Sequential(
            Linear(h, h), GELU(),
            LayerNorm(h, cfg.layer_norm_eps, cfg.layer_norm_impl),
            Linear(h, label_dim))

    def forward(self, x):
        return self.net(x)


class AttentionPool(nn.Module):
    """Learned scalar-score softmax pooling: score = ReLU(fc(x)), -1e4 at
    padding, fp32 softmax over the sequence, dropout on the weights, then
    the weighted sum of x in x's dtype."""

    def __init__(self, hidden_size: int, drop: float = 0.0):
        super().__init__()
        self.fc = nn.Sequential(Linear(hidden_size, 1), nn.ReLU())
        self.drop = drop

    def forward(self, x, pad_mask=None, *, deterministic: bool = True,
                generator=None):
        """x: [B, T, D]; pad_mask: [B, T] True at padding."""
        score = self.fc(x).squeeze(-1).float()
        if pad_mask is not None:
            score = score + pad_mask.float() * -1e4
        probs = torch.softmax(score, dim=1)
        w = dropout(probs, self.drop, deterministic=deterministic,
                    generator=generator,
                    row_base=rows_before(batch_block(generator)[0],
                                         probs.shape))
        return torch.einsum("bt,btd->bd", w.to(x.dtype), x)


class CrossAttention(nn.Module):
    """Multi-head attention of ``query`` over ``key``/``value`` with one
    [3H, H] input projection (torch's ``in_proj_weight``/``in_proj_bias``)
    and ``out_proj``. Padded keys (``key_padding_mask`` True) take the
    trunk's -10000 additive bias; the attention itself is
    ``multi_head_attention`` (K1/K2 on the card with
    ``attention_impl="cuda"``), dropout on P at the config's rate."""

    def __init__(self, cfg: UniterConfig):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.in_proj_weight = nn.Parameter(torch.empty(3 * h, h))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * h))
        self.out_proj = Linear(h, h)
        nn.init.normal_(self.in_proj_weight, 0.0, cfg.initializer_range)

    def forward(self, query, key, value, key_padding_mask=None, *,
                deterministic: bool = True, generator=None):
        """query: [B, Tq, D]; key/value: [B, Tk, D]; key_padding_mask:
        [B, Tk] True at padding. Returns [B, Tq, D]."""
        cfg = self.cfg
        nh, d = cfg.num_attention_heads, cfg.head_dim
        b, tq, hid = query.shape
        tk = key.shape[1]
        w = self.in_proj_weight.to(query.dtype)
        bias = self.in_proj_bias.to(query.dtype)
        q = torch.nn.functional.linear(query, w[:hid], bias[:hid])
        k = torch.nn.functional.linear(key, w[hid:2 * hid], bias[hid:2 * hid])
        v = torch.nn.functional.linear(value, w[2 * hid:], bias[2 * hid:])
        if key_padding_mask is not None:
            attn_bias = key_padding_mask.float() * MASK_VALUE
        else:
            attn_bias = torch.zeros(b, tk, device=query.device)
        rate = cfg.attention_probs_dropout_prob
        seed = live_seed(rate, deterministic, generator)
        ctx = multi_head_attention(
            q.view(b, tq, nh, d), k.view(b, tk, nh, d), v.view(b, tk, nh, d),
            attn_bias, impl=cfg.attention_impl, dropout_rate=rate,
            deterministic=seed is None, seed=seed,
            row_base=rows_before(batch_block(generator)[0],
                                 (b, nh, tq, tk))).reshape(b, tq, hid)
        return self.out_proj(ctx)
