"""The single-stream UNITER encoder in PyTorch.

Counterpart of ``uniter_tpu/models/encoder.py`` (the reference's
``UniterModel``, model/model.py:217-367, and BERT blocks,
model/layer.py:53-186). The joint sequence keeps the JAX package's fixed
segment layout ``[txt (CLS at 0, padded) ; img (padded)]``; parameters are
stored fp32 and activations run in ``config.dtype``; LayerNorm statistics
and the attention softmax run in fp32; LN eps is 1e-12 and GELU the erf
form.

Dropout (rate 0.1 in training) is live at both embedding tails, both
sub-block tails and the attention probabilities when ``deterministic`` is
False. Each such call draws its own seed from the ``generator`` argument, a
``torch.Generator`` the train step makes per step (never torch's global
one), so a step's masks are a function of that generator's seed alone.
With ``block_fusion="cuda"`` each live tail runs as one fused Function
(K3/K4 at the sub-block tails, K5/K6 at the embedding tails) on the same
seed and the same Philox bits as the plain composition. Every LayerNorm
that no fused tail takes (the image embeddings' two, each tail when no mask
is live) follows ``layer_norm_impl``: "cuda" is K8, "xla" the plain one.
With ``ffn_impl="cuda"`` and the gelu activation each layer's FFN runs as
one ``ops.ffn.FfnFunction`` (K9 on the card) over the same
``intermediate.dense`` and ``output.dense`` parameters. The plain tails'
masks follow ``dropout_impl`` (``ops/dropout.py``: the 32-bit rule, or
the u16/u8 ones); K1-K6 keep the 32-bit rule.

``remat`` (``--remat``; JAX ``nn.remat`` around each scanned layer,
``uniter_tpu/models/encoder.py:425-426``) runs each BERT layer under
``torch.utils.checkpoint`` while gradients are recorded: its activations
are recomputed in the backward, the embeddings' are kept. A layer draws
its three dropout seeds (K1's on P, then its two tails') from the step's
explicit generator *before* the checkpointed call and passes them in:
checkpoint restores torch's global generators for the recompute, never an
explicit one, so seeds drawn inside would differ between the forward and
the recompute and the gradient would silently belong to other masks.
Drawn outside, the same generator gives the same masks with and without
``remat``.

``BertLayerCLS`` computes only the CLS row of a layer (the retrieval
scorer's last layer, ``utils/itm_fast.py``); it loads a ``BertLayer``'s
state dict as it is.

Submodules are named after the reference ``.pt`` keys that
``uniter_tpu.models.checkpoint.export_state_dict`` emits (for example
``encoder.layer.3.attention.self.query.weight``), so those state dicts load
with ``strict=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from uniter_tpu_torch.config import UniterConfig
from uniter_tpu_torch.ops.activations import ACT2FN
from uniter_tpu_torch.ops.attention import multi_head_attention
from uniter_tpu_torch.ops.dropout import drop, live_seed
from uniter_tpu_torch.ops.ffn import ffn
from uniter_tpu_torch.ops.fused_block import drop_res_ln, ln_drop
from uniter_tpu_torch.ops.layer_norm import layer_norm

MASK_VALUE = -10000.0  # additive padding bias, reference model/model.py:345


class Linear(nn.Linear):
    """``nn.Linear`` with fp32 parameters, computing in the input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """LayerNorm with torch-style (weight, bias) and fp32 statistics;
    ``impl`` is the config's ``layer_norm_impl`` ("cuda": K8 on the card)."""

    def __init__(self, features: int, eps: float = 1e-12, impl: str = "xla"):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps
        self.impl = impl

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, self.impl)


class _Tail(LayerNorm):
    """A LayerNorm with the hidden dropout of ``cfg``: its rate, the fused
    kernels when ``block_fusion`` is "cuda", else the plain dropout by
    ``dropout_impl``."""

    def __init__(self, cfg: UniterConfig):
        super().__init__(cfg.hidden_size, cfg.layer_norm_eps,
                         cfg.layer_norm_impl)
        self.rate = cfg.hidden_dropout_prob
        self.fused = cfg.block_fusion == "cuda"
        self.drop_impl = cfg.dropout_impl


class DropResLN(_Tail):
    """``LayerNorm(dropout(x) + res)``: the tail of both BERT sub-blocks
    (reference model/layer.py:104-127,158-170). Parameters are a plain
    LayerNorm's. ``seed`` is the tail's dropout seed (``BertLayer.seeds``)
    or None when no mask is live. With ``fused`` and a live mask the tail
    is one ``ops.fused_block.drop_res_ln`` (K3 forward, K4 backward on the
    card), on the same seed and Philox bits as the plain composition;
    otherwise, as in the JAX module (:65), the plain composition."""

    def forward(self, x, res, seed=None):
        if seed is not None and self.fused:
            return drop_res_ln(x, res, self.weight, self.bias, rate=self.rate,
                               seed=seed, eps=self.eps)
        if seed is not None:
            x = drop(x, self.rate, seed, self.drop_impl)
        return layer_norm(x + res, self.weight, self.bias, self.eps,
                          self.impl)


class LNDrop(_Tail):
    """``dropout(LayerNorm(x))``: the embedding tails (reference
    model/model.py:241-244,269-271); with ``fused`` and a live mask one
    ``ops.fused_block.ln_drop`` (K5/K6 on the card)."""

    def forward(self, x, deterministic: bool = True, generator=None):
        seed = live_seed(self.rate, deterministic, generator)
        if seed is not None and self.fused:
            return ln_drop(x, self.weight, self.bias, rate=self.rate,
                           seed=seed, eps=self.eps)
        y = layer_norm(x, self.weight, self.bias, self.eps, self.impl)
        return y if seed is None else drop(y, self.rate, seed,
                                           self.drop_impl)


# On the card the lookup's gradient must be the same every run: CUDA's
# embedding backward sums a row hit by many ids in an order that changes
# from run to run. Tables of at most this many rows (the token types, each
# row hit by thousands of ids) are read as a one-hot product, whose
# backward is a GEMM; larger ones go through ``SortedLookup``.
ONE_HOT_ROWS = 16


class SortedLookup(torch.autograd.Function):
    """``F.embedding`` whose backward sums each row's gradients in one
    fixed order, in fp32: ids sorted (stable), then one pass a row
    (``segment_reduce``). No host sync: the per-row counts come from an
    integer scatter-add and the output has the table's size."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1).long()
        g = g.reshape(flat.numel(), -1)
        perm = torch.sort(flat, stable=True).indices
        counts = torch.zeros(ctx.rows, dtype=torch.int64, device=flat.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat))
        dw = torch.segment_reduce(g[perm].float(), "sum", lengths=counts,
                                  axis=0, unsafe=True)
        return None, dw.to(g.dtype)


class Embed(nn.Embedding):
    """Embedding table with fp32 storage; the lookup returns the compute
    dtype. Ids out of range are clamped, as the JAX package's
    ``jnp.take(mode="clip")`` does (a plain lookup would raise on the CPU
    and trip a device assert on the card). On the card the gradient is
    the same every run: a table of at most ``ONE_HOT_ROWS`` rows is read
    as one-hot ids times the table (the same values: one product by 1.0 a
    row, sums of zeros), a larger one through ``SortedLookup``."""

    def __init__(self, num: int, features: int, dtype: torch.dtype):
        super().__init__(num, features)
        self.compute_dtype = dtype

    def forward(self, ids):
        ids = ids.clamp(0, self.num_embeddings - 1)
        w = self.weight
        if not w.is_cuda:
            out = F.embedding(ids, w)
        elif self.num_embeddings <= ONE_HOT_ROWS:
            out = F.one_hot(ids.long(), self.num_embeddings).to(w.dtype) @ w
        else:
            out = SortedLookup.apply(ids, w)
        return out.to(self.compute_dtype)


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
        self.LayerNorm = LNDrop(cfg)

    def forward(self, input_ids, position_ids, token_type_ids=None, *,
                deterministic: bool = True, generator=None):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(emb, deterministic, generator)


class UniterImageEmbeddings(nn.Module):
    """RoI features + 7-d box geometry -> token space (reference
    model/model.py:248-272). ``mask_embedding`` row 1 is added at
    MRM-masked positions; row 0 is never read."""

    def __init__(self, cfg: UniterConfig, img_dim: int = 2048):
        super().__init__()
        self.compute_dtype = cfg.compute_dtype
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.img_linear = Linear(img_dim, h)
        self.img_layer_norm = LayerNorm(h, eps, cfg.layer_norm_impl)
        self.pos_linear = Linear(7, h)
        self.pos_layer_norm = LayerNorm(h, eps, cfg.layer_norm_impl)
        self.mask_embedding = nn.Embedding(2, img_dim)
        self.LayerNorm = LNDrop(cfg)

    def forward(self, img_feat, img_pos_feat, type_embeddings,
                img_masks=None, *, deterministic: bool = True,
                generator=None):
        if img_masks is not None:
            row = self.mask_embedding.weight[1].to(img_feat.dtype)
            img_feat = img_feat + torch.where(
                img_masks[..., None].bool(), row, torch.zeros_like(row))
        dt = self.compute_dtype
        im = self.img_layer_norm(self.img_linear(img_feat.to(dt)))
        pos = self.pos_layer_norm(self.pos_linear(img_pos_feat.to(dt)))
        return self.LayerNorm(im + pos + type_embeddings, deterministic,
                              generator)


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
        self.LayerNorm = DropResLN(cfg)


class BertAttention(nn.Module):
    """Self-attention + output projection + residual LN (reference
    model/layer.py:53-127)."""

    def __init__(self, cfg: UniterConfig):
        super().__init__()
        self.cfg = cfg
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, hidden, bias, attn_seed=None, tail_seed=None):
        """``attn_seed``: K1's dropout seed on P; ``tail_seed``: the output
        tail's (``BertLayer.seeds``); None where no mask is live."""
        cfg = self.cfg
        b, s, _ = hidden.shape
        nh, d, hs = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
        sa = self.self
        if cfg.fused_qkv:
            # one [3H, H] GEMM; q/k/v are strided views of its output, which
            # the kernels read through strides (K2's contiguous gradients
            # flow back into the projection's gradient through autograd)
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
            deterministic=attn_seed is None, seed=attn_seed).reshape(b, s, hs)
        out = self.output.dense(ctx)
        return self.output.LayerNorm(out, hidden, tail_seed)


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
        self.LayerNorm = DropResLN(cfg)


class BertLayer(nn.Module):
    """Post-LN BERT layer: attention -> FFN(gelu) -> residual LN (reference
    model/layer.py:130-170). The FFN is one ``ops.ffn.ffn(impl="cuda")``
    when ``ffn_impl`` is "cuda" and the activation gelu, as the JAX layer
    takes its kernel (:329-332)."""

    def __init__(self, cfg: UniterConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)
        self.fused_ffn = cfg.ffn_impl == "cuda" and cfg.hidden_act == "gelu"

    def feed_forward(self, x):
        if self.fused_ffn:
            w1, w2 = self.intermediate.dense, self.output.dense
            return ffn(x, w1.weight, w1.bias, w2.weight, w2.bias, impl="cuda")
        return self.output.dense(self.intermediate(x))

    def seeds(self, deterministic: bool = True, generator=None):
        """The layer's three dropout seeds from ``generator``, in the order
        its calls take them: K1's on P, the attention tail's, the FFN
        tail's; None where no mask is live."""
        rates = (self.cfg.attention_probs_dropout_prob,
                 self.cfg.hidden_dropout_prob, self.cfg.hidden_dropout_prob)
        return tuple(live_seed(r, deterministic, generator) for r in rates)

    def seeded(self, hidden, bias, attn_seed, tail1_seed, tail2_seed):
        """The layer on seeds drawn beforehand (``seeds``)."""
        attn_out = self.attention(hidden, bias, attn_seed, tail1_seed)
        out = self.feed_forward(attn_out)
        return self.output.LayerNorm(out, attn_out, tail2_seed)

    def forward(self, hidden, bias, deterministic: bool = True,
                generator=None):
        return self.seeded(hidden, bias,
                           *self.seeds(deterministic, generator))


class BertAttentionCLS(BertAttention):
    """Inference-only attention that computes the CLS (position 0) row
    alone (JAX ``BertAttentionCLS``): a [1, S] query against every key,
    the plain attention (one query row is far below the kernel's tiles),
    then the output projection and LayerNorm on that row. Parameters are
    ``BertAttention``'s."""

    def forward(self, hidden, bias, attn_seed=None, tail_seed=None):
        cfg = self.cfg
        b, s, _ = hidden.shape
        nh, d = cfg.num_attention_heads, cfg.head_dim
        sa = self.self
        q = sa.query(hidden[:, :1]).view(b, 1, nh, d)
        k, v = (m(hidden).view(b, s, nh, d) for m in (sa.key, sa.value))
        ctx = multi_head_attention(q, k, v, bias, impl="xla").reshape(
            b, 1, cfg.hidden_size)
        return self.output.LayerNorm(self.output.dense(ctx), hidden[:, :1])


class BertLayerCLS(BertLayer):
    """The last BERT layer restricted to the CLS row (JAX
    ``BertLayerCLS``): attention is the only op across positions and its
    query rows are independent, so this is ``BertLayer(...)[:, :1]``. The
    FFN on its one row is the unfused Linear -> activation -> Linear
    whatever ``ffn_impl`` says, as in the JAX layer. Returns [B, 1, H]."""

    def __init__(self, cfg: UniterConfig):
        super().__init__(cfg)
        self.attention = BertAttentionCLS(cfg)
        self.fused_ffn = False

    def forward(self, hidden, bias, deterministic: bool = True,
                generator=None):
        attn_out = self.attention(hidden, bias)
        out = self.feed_forward(attn_out)
        return self.output.LayerNorm(out, attn_out)


class UniterEncoder(nn.Module):
    """``num_hidden_layers`` BERT layers run in turn (reference
    model/model.py:275-292); only the last layer's states are returned.
    With ``remat`` each layer is checkpointed on seeds drawn before it
    (module docstring)."""

    def __init__(self, cfg: UniterConfig):
        super().__init__()
        self.remat = cfg.remat
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden, bias, deterministic: bool = True,
                generator=None, n_layers=None):
        for layer in self.layer[:n_layers]:
            seeds = layer.seeds(deterministic, generator)
            if self.remat and torch.is_grad_enabled():
                # the masks come from the seeds passed in; no global
                # generator is read, so none needs restoring
                hidden = checkpoint(layer.seeded, hidden, bias, *seeds,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                hidden = layer.seeded(hidden, bias, *seeds)
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
    the pooler is called by the heads. A head that never reads the pooler
    (NLVR2 paired-attn) builds the trunk with ``pooler=False``: flax creates
    no parameters for an uncalled submodule, so the JAX package's
    parameter tree has none to bridge.
    """

    def __init__(self, cfg: UniterConfig, img_dim: int = 2048,
                 pooler: bool = True):
        super().__init__()
        self.config = cfg
        self.embeddings = UniterTextEmbeddings(cfg)
        self.img_embeddings = UniterImageEmbeddings(cfg, img_dim)
        self.encoder = UniterEncoder(cfg)
        if pooler:
            self.pooler = BertPooler(cfg)

    def encode(self, emb, attn_mask, deterministic: bool = True,
               generator=None, n_layers=None):
        """The encoder layers on joint embeddings ``emb`` [B, S, H] under
        the 0/1 validity mask [B, S] (JAX ``UniterModel.encode``); with
        ``n_layers`` only the first that many (the retrieval scorer runs
        the last one as ``BertLayerCLS``)."""
        return self.encoder(emb, attn_bias(attn_mask), deterministic,
                            generator, n_layers)

    def forward(self, input_ids=None, position_ids=None, img_feat=None,
                img_pos_feat=None, attn_mask=None, img_masks=None,
                txt_type_ids=None, img_type_ids=None, *,
                deterministic: bool = True, generator=None):
        embs = []
        if input_ids is not None:
            embs.append(self.embeddings(input_ids, position_ids, txt_type_ids,
                                        deterministic=deterministic,
                                        generator=generator))
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
                                            deterministic=deterministic,
                                            generator=generator))
        emb = embs[0] if len(embs) == 1 else torch.cat(embs, dim=1)
        return self.encoder(emb, attn_bias(attn_mask), deterministic,
                            generator)
