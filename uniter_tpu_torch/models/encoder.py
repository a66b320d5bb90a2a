"""The single-stream UNITER encoder in PyTorch.

Counterpart of ``uniter_tpu/models/encoder.py`` (the reference's
``UniterModel``, model/model.py:217-367, and BERT blocks,
model/layer.py:53-186). The joint sequence keeps the JAX package's fixed
segment layout ``[txt (CLS at 0, padded) ; img (padded)]``; parameters are
stored fp32 and activations run in ``config.dtype``; LayerNorm statistics
and the attention softmax run in fp32; LN eps is 1e-12 and GELU the erf
form.

Submodules are named after the reference ``.pt`` keys that
``uniter_tpu.models.checkpoint.export_state_dict`` emits (for example
``encoder.layer.3.attention.self.query.weight``), so those state dicts load
with ``strict=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from uniter_tpu_torch.config import UniterConfig
from uniter_tpu_torch.ops.activations import ACT2FN
from uniter_tpu_torch.ops.attention import multi_head_attention
from uniter_tpu_torch.ops.dropout import dropout
from uniter_tpu_torch.ops.layer_norm import layer_norm

MASK_VALUE = -10000.0  # additive padding bias, reference model/model.py:345


class Linear(nn.Linear):
    """``nn.Linear`` with fp32 parameters, computing in the input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """LayerNorm with torch-style (weight, bias) and fp32 statistics."""

    def __init__(self, features: int, eps: float = 1e-12):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class DropResLN(LayerNorm):
    """``LayerNorm(dropout(x) + res)``: the tail of both BERT sub-blocks
    (reference model/layer.py:104-127,158-170). Parameters are a plain
    LayerNorm's. The fused Pallas tail runs only while a dropout mask is
    live, so inference takes this plain composition on every device."""

    def __init__(self, features: int, rate: float, eps: float = 1e-12):
        super().__init__(features, eps)
        self.rate = rate

    def forward(self, x, res, deterministic: bool = True):
        x = dropout(x, self.rate, deterministic=deterministic)
        return layer_norm(x + res, self.weight, self.bias, self.eps)


class LNDrop(LayerNorm):
    """``dropout(LayerNorm(x))``: the embedding tails (reference
    model/model.py:241-244,269-271)."""

    def __init__(self, features: int, rate: float, eps: float = 1e-12):
        super().__init__(features, eps)
        self.rate = rate

    def forward(self, x, deterministic: bool = True):
        y = layer_norm(x, self.weight, self.bias, self.eps)
        return dropout(y, self.rate, deterministic=deterministic)


class Embed(nn.Embedding):
    """Embedding table with fp32 storage; the lookup returns the compute
    dtype. Ids out of range are clamped, as the JAX package's
    ``jnp.take(mode="clip")`` does (a plain lookup would raise on the CPU
    and trip a device assert on the card)."""

    def __init__(self, num: int, features: int, dtype: torch.dtype):
        super().__init__(num, features)
        self.compute_dtype = dtype

    def forward(self, ids):
        ids = ids.clamp(0, self.num_embeddings - 1)
        return F.embedding(ids, self.weight).to(self.compute_dtype)


class UniterTextEmbeddings(nn.Module):
    """word + position + token-type embeddings -> LN -> dropout
    (reference model/model.py:217-245)."""

    def __init__(self, cfg: UniterConfig):
        super().__init__()
        dt = cfg.compute_dtype
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, dt)
        self.position_embeddings = Embed(cfg.max_position_embeddings,
                                         cfg.hidden_size, dt)
        self.token_type_embeddings = Embed(cfg.type_vocab_size,
                                           cfg.hidden_size, dt)
        self.LayerNorm = LNDrop(cfg.hidden_size, cfg.hidden_dropout_prob,
                                cfg.layer_norm_eps)

    def forward(self, input_ids, position_ids, token_type_ids=None, *,
                deterministic: bool = True):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(emb, deterministic=deterministic)


class UniterImageEmbeddings(nn.Module):
    """RoI features + 7-d box geometry -> token space (reference
    model/model.py:248-272). ``mask_embedding`` row 1 is added at
    MRM-masked positions; row 0 is never read."""

    def __init__(self, cfg: UniterConfig, img_dim: int = 2048):
        super().__init__()
        self.compute_dtype = cfg.compute_dtype
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.img_linear = Linear(img_dim, h)
        self.img_layer_norm = LayerNorm(h, eps)
        self.pos_linear = Linear(7, h)
        self.pos_layer_norm = LayerNorm(h, eps)
        self.mask_embedding = nn.Embedding(2, img_dim)
        self.LayerNorm = LNDrop(h, cfg.hidden_dropout_prob, eps)

    def forward(self, img_feat, img_pos_feat, type_embeddings,
                img_masks=None, *, deterministic: bool = True):
        if img_masks is not None:
            row = self.mask_embedding.weight[1].to(img_feat.dtype)
            img_feat = img_feat + torch.where(
                img_masks[..., None].bool(), row, torch.zeros_like(row))
        dt = self.compute_dtype
        im = self.img_layer_norm(self.img_linear(img_feat.to(dt)))
        pos = self.pos_layer_norm(self.pos_linear(img_pos_feat.to(dt)))
        return self.LayerNorm(im + pos + type_embeddings,
                              deterministic=deterministic)


class BertSelfAttention(nn.Module):
    """The query/key/value projections (reference model/layer.py:75-101)."""

    def __init__(self, cfg: UniterConfig):
        super().__init__()
        h = cfg.hidden_size
        self.query = Linear(h, h)
        self.key = Linear(h, h)
        self.value = Linear(h, h)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: UniterConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = DropResLN(cfg.hidden_size, cfg.hidden_dropout_prob,
                                   cfg.layer_norm_eps)


class BertAttention(nn.Module):
    """Self-attention + output projection + residual LN (reference
    model/layer.py:53-127)."""

    def __init__(self, cfg: UniterConfig):
        super().__init__()
        self.cfg = cfg
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, hidden, bias, deterministic: bool = True):
        cfg = self.cfg
        b, s, _ = hidden.shape
        nh, d, hs = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
        sa = self.self
        if cfg.fused_qkv:
            # one [3H, H] GEMM; q/k/v are strided views of its output, which
            # the kernel reads through strides
            w = torch.cat([sa.query.weight, sa.key.weight, sa.value.weight])
            bvec = torch.cat([sa.query.bias, sa.key.bias, sa.value.bias])
            qkv = F.linear(hidden, w.to(hidden.dtype), bvec.to(hidden.dtype))
            q, k, v = (qkv[..., i * hs:(i + 1) * hs].view(b, s, nh, d)
                       for i in range(3))
        else:
            q, k, v = (m(hidden).view(b, s, nh, d)
                       for m in (sa.query, sa.key, sa.value))
        ctx = multi_head_attention(
            q, k, v, bias, impl=cfg.attention_impl,
            dropout_rate=cfg.attention_probs_dropout_prob,
            deterministic=deterministic).reshape(b, s, hs)
        out = self.output.dense(ctx)
        return self.output.LayerNorm(out, hidden, deterministic)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: UniterConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.act = ACT2FN[cfg.hidden_act]

    def forward(self, x):
        return self.act(self.dense(x))


class BertOutput(nn.Module):
    def __init__(self, cfg: UniterConfig):
        super().__init__()
        self.dense = Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = DropResLN(cfg.hidden_size, cfg.hidden_dropout_prob,
                                   cfg.layer_norm_eps)


class BertLayer(nn.Module):
    """Post-LN BERT layer: attention -> FFN(gelu) -> residual LN (reference
    model/layer.py:130-170)."""

    def __init__(self, cfg: UniterConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden, bias, deterministic: bool = True):
        attn_out = self.attention(hidden, bias, deterministic)
        out = self.output.dense(self.intermediate(attn_out))
        return self.output.LayerNorm(out, attn_out, deterministic)


class UniterEncoder(nn.Module):
    """``num_hidden_layers`` BERT layers run in turn (reference
    model/model.py:275-292); only the last layer's states are returned."""

    def __init__(self, cfg: UniterConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden, bias, deterministic: bool = True):
        for layer in self.layer:
            hidden = layer(hidden, bias, deterministic)
        return hidden


class BertPooler(nn.Module):
    """[CLS] (position 0) -> Dense -> tanh (reference model/layer.py:173-185)."""

    def __init__(self, cfg: UniterConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


def attn_bias(attn_mask):
    """0/1 validity mask [B, S] -> additive fp32 bias (0 valid / -10000
    pad)."""
    return (1.0 - attn_mask.float()) * MASK_VALUE


class UniterModel(nn.Module):
    """Joint vision-language encoder.

    The joint sequence is ``[txt tokens (T, CLS at 0) ; img regions (R)]``;
    ``attn_mask`` is the [B, T+R] 0/1 validity mask over both segments.
    Pass ``input_ids=None`` for image-only or ``img_feat=None`` for
    text-only encoding (the reference's three input modes,
    model/model.py:348-360). ``forward`` returns the last layer's states;
    the pooler is called by the heads.
    """

    def __init__(self, cfg: UniterConfig, img_dim: int = 2048):
        super().__init__()
        self.config = cfg
        self.embeddings = UniterTextEmbeddings(cfg)
        self.img_embeddings = UniterImageEmbeddings(cfg, img_dim)
        self.encoder = UniterEncoder(cfg)
        self.pooler = BertPooler(cfg)

    def forward(self, input_ids=None, position_ids=None, img_feat=None,
                img_pos_feat=None, attn_mask=None, img_masks=None,
                txt_type_ids=None, img_type_ids=None, *,
                deterministic: bool = True):
        embs = []
        if input_ids is not None:
            embs.append(self.embeddings(input_ids, position_ids, txt_type_ids,
                                        deterministic=deterministic))
        if img_feat is not None:
            if img_type_ids is None:
                img_type_ids = torch.ones(img_feat.shape[:2],
                                          dtype=torch.long,
                                          device=img_feat.device)
            # image token-type rows live in the shared text table
            # (reference model/model.py:313-316)
            type_emb = self.embeddings.token_type_embeddings(img_type_ids)
            embs.append(self.img_embeddings(img_feat, img_pos_feat, type_emb,
                                            img_masks,
                                            deterministic=deterministic))
        emb = embs[0] if len(embs) == 1 else torch.cat(embs, dim=1)
        return self.encoder(emb, attn_bias(attn_mask), deterministic)
