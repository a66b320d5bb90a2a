"""BEiT-3 (arXiv:2208.10442, "Image as a Foreign Language") for VQA serving.

The Multiway Transformer of microsoft/unilm ``beit3`` on torchscale's
``EncoderLayer`` (``architecture/encoder.py``), ``MultiwayNetwork``
(``component/multiway_network.py``) and ``model/BEiT3.py``, with
``BEiT3ForVisualQuestionAnswering``'s pooler and head
(``beit3/modeling_finetune.py``). Inference only: training it raises.

The sequence is ``[vision CLS, patches | text bos ... eos, pads]``; the
multiway split is at ``num_patches + 1`` (901 at 480 px). Every module
marked ``_m`` below holds two weight sets, ``A`` for the vision rows
(positions before the split) and ``B`` for the text rows, under
torchscale's names (``...q_proj.A.weight``), so a released state dict maps
one to one. Attention is shared over the whole sequence, text pads masked
as keys. A layer is pre-LN with sub-LN::

    a  = LN1_m(x)
    h  = x + Out_m(LNin_m(MHA(Q_m a, K_m a, V_m a)))
    f  = LN2_m(h)
    x' = h + FC2_m(LNffn_m(GELU(FC1_m f)))

and the encoder's output is ``LNout_m(x_L)`` when ``normalize_output``
(torchscale's default; the VQA models of ``modeling_finetune.py`` turn it
off, and the pooler's own LayerNorm follows). Embeddings: a 16x16 stride-16
patch convolution of pixels scaled to [0, 1] and normalised by mean and
std 0.5, a learned CLS and position table (fairseq offset 2) for the
vision rows; a token table and its own position table (offset 2) for the
text rows. Head: the pooler (LN, Linear, tanh on row 0), then Linear(H,
2H) -> LN(2H) -> GELU -> Linear(2H, answers).

The batch carries each call's distinct images once (``pixel_values`` uint8
[n_img, 3, size, size]) and ``img_index`` [pairs]: the patch embedding runs
once an image and is gathered to the pairs. Text (``input_ids`` [pairs, T]
with bos and eos, ``text_mask`` [pairs, T]) is padded to the call's longest
question, rounded up to a multiple of 8.

Parameters are stored fp32 and computed in ``dtype``; LayerNorm statistics
and the attention softmax run in fp32. Every expert GEMM runs on its
segment's rows: each multiway projection splits its input by segment (a
copy of each part) and merges the two outputs back (a copy), counted in
``utils.trace`` as ``multiway.split_bytes``; the rows through each expert's
GEMMs as ``multiway.rows.vision`` / ``multiway.rows.text``. The residual
and LayerNorm tails (``LN1_m``, ``LNin_m``, ``LN2_m``, ``LNout_m``) go
through ``ops.fused_block.multiway_tail_fwd``: on the card one launch each
(K3's row code for ``h = x + y; f = LN_m(h)``, which also stores ``h``;
K5's for ``LN_m(x)``), counted ``tail.fused``; on the CPU its plain
version, counted ``tail.plain``. The 4H-wide ``LNffn_m`` and the head's
2H-wide LayerNorm stay plain (``tail.plain``); the pooler's LayerNorm takes
K5 at rate 0 where ``inference_tail`` takes it. Spans: ``beit3.embed``,
``beit3.encoder``, ``beit3.head``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from uniter_tpu_torch.config import _DTYPES
from uniter_tpu_torch.models.encoder import MASK_VALUE, Embed, LayerNorm, Linear
from uniter_tpu_torch.ops.attention import multi_head_attention
from uniter_tpu_torch.ops.fused_block import inference_tail, multiway_tail_fwd
from uniter_tpu_torch.utils import trace

POS_OFFSET = 2  # fairseq's first position


@dataclasses.dataclass(frozen=True)
class Beit3Config:
    """torchscale ``EncoderConfig`` keys of a BEiT-3 model (``beit3``
    ``modeling_utils.py`` ``_get_large_config``) and the port's compute
    policy."""

    encoder_embed_dim: int = 1024
    encoder_attention_heads: int = 16
    encoder_ffn_embed_dim: int = 4096
    encoder_layers: int = 24
    vocab_size: int = 64010
    img_size: int = 480
    patch_size: int = 16
    in_chans: int = 3
    layernorm_eps: float = 1e-5
    max_source_positions: int = 1024
    normalize_output: bool = True
    # XLM-R sentencepiece's specials
    bos_token_id: int = 0
    pad_token_id: int = 1
    eos_token_id: int = 2
    # --- compute policy ---
    dtype: str = "bfloat16"
    # "cuda" (K1) or "xla" (plain); "auto"/"pallas"/"pallas_nt" resolve as
    # for UNITER
    attention_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        return self.encoder_embed_dim // self.encoder_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def split(self) -> int:
        """The multiway split: the vision rows (CLS and patches)."""
        return self.num_patches + 1

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def replace(self, **kw) -> "Beit3Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any], **overrides) -> "Beit3Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw.update(overrides)
        return cls(**kw)


def resolve_beit3_policies(cfg: Beit3Config, device) -> Beit3Config:
    """The attention policy for ``device``, as ``resolve_kernel_policies``
    resolves UNITER's: "auto", "pallas", "pallas_nt" and "cuda" select K1
    on a CUDA device and the plain version elsewhere. The tails need no
    policy (the card always takes the multiway K3/K5). BEiT-3 serves only
    (``forward`` with a loss and ``training.driver`` refuse it): training
    it needs K2 past 512 positions and its own recipe."""
    att = cfg.attention_impl
    if att in ("auto", "pallas", "pallas_nt", "cuda"):
        att = "cuda" if torch.device(device).type == "cuda" else "xla"
    elif att != "xla":
        raise ValueError(f"unknown attention_impl {att!r}")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return cfg.replace(attention_impl=att)


def split_rows(x, split: int):
    """(vision rows [B*split, ...], text rows [B*(S-split), ...]) of x [B,
    S, ...]; each part that is not already one block is copied, counted in
    ``multiway.split_bytes``."""
    b, s = x.shape[:2]
    parts = (x[:, :split], x[:, split:])
    copied = sum(p.numel() for p in parts if not p.is_contiguous())
    trace.count("multiway.split_bytes", copied * x.element_size())
    return tuple(p.reshape(-1, *x.shape[2:]) for p in parts)


def merge_rows(yv, yt, b: int):
    """The vision and text rows ([B*split, N] or [B, split, N], and the
    same of the text) back as one [B, S, N] tensor (a copy, counted in
    ``multiway.split_bytes``)."""
    y = torch.cat((yv.view(b, -1, yv.shape[-1]),
                   yt.view(b, -1, yt.shape[-1])), 1)
    trace.count("multiway.split_bytes", y.numel() * y.element_size())
    return y


def _count_rows(xv, xt):
    trace.count("multiway.rows.vision", xv.shape[0])
    trace.count("multiway.rows.text", xt.shape[0])


def plain_layer_norm(x, ln: LayerNorm):
    """A LayerNorm no tail takes (the 4H-wide sub-LN, the head's 2H-wide
    one): one ``F.layer_norm`` in x's dtype (fp32 statistics). The caller
    counts it ``tail.plain``, once for both experts of a multiway one."""
    return F.layer_norm(x, x.shape[-1:], ln.weight.to(x.dtype),
                        ln.bias.to(x.dtype), ln.eps)


class Multiway(nn.Module):
    """Two experts under torchscale's names: ``A`` (vision rows) and ``B``
    (text rows)."""

    def __init__(self, a: nn.Module, b: nn.Module):
        super().__init__()
        self.A = a
        self.B = b


class MultiwayLinear(Multiway):
    def __init__(self, d_in: int, d_out: int):
        super().__init__(Linear(d_in, d_out), Linear(d_in, d_out))

    def forward(self, xv, xt):
        _count_rows(xv, xt)
        return self.A(xv), self.B(xt)


class MultiwayLayerNorm(Multiway):
    def __init__(self, h: int, eps: float):
        super().__init__(LayerNorm(h, eps), LayerNorm(h, eps))

    def tail(self, x, res, split: int, keep_sum: bool = True):
        """``LN_m(x)`` (``res`` None) or ``(x + res, LN_m(x + res))`` over
        x [B, S, H] in one ``multiway_tail_fwd`` (the multiway K5/K3 on the
        card, counted ``tail.fused``; the plain version on the CPU)."""
        trace.count("tail.fused" if x.is_cuda else "tail.plain")
        return multiway_tail_fwd(x, res, self.A.weight, self.A.bias,
                                 self.B.weight, self.B.bias, split,
                                 self.A.eps, keep_sum)


class FeedForward(nn.Module):
    """torchscale's ``FeedForwardNetwork`` with sub-LN: fc1 -> GELU (erf)
    -> LN(ffn dim) -> fc2."""

    def __init__(self, cfg: Beit3Config):
        super().__init__()
        h, i = cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim
        self.fc1 = Linear(h, i)
        self.fc2 = Linear(i, h)
        self.ffn_layernorm = LayerNorm(i, cfg.layernorm_eps)

    def forward(self, x):
        return self.fc2(plain_layer_norm(F.gelu(self.fc1(x)),
                                         self.ffn_layernorm))


class MultiheadAttention(nn.Module):
    """torchscale's ``MultiheadAttention`` with multiway projections and
    the sub-LN ``inner_attn_ln`` before the output projection."""

    def __init__(self, cfg: Beit3Config):
        super().__init__()
        h = cfg.encoder_embed_dim
        self.cfg = cfg
        self.k_proj = MultiwayLinear(h, h)
        self.v_proj = MultiwayLinear(h, h)
        self.q_proj = MultiwayLinear(h, h)
        self.out_proj = MultiwayLinear(h, h)
        self.inner_attn_ln = MultiwayLayerNorm(h, cfg.layernorm_eps)

    def _qkv(self, av, at):
        """Each expert's Q, K and V in one GEMM ([rows, 3H])."""
        _count_rows(av, at)
        out = []
        for x, e in ((av, "A"), (at, "B")):
            lins = [getattr(p, e) for p in (self.q_proj, self.k_proj,
                                            self.v_proj)]
            w = torch.cat([m.weight for m in lins]).to(x.dtype)
            b = torch.cat([m.bias for m in lins]).to(x.dtype)
            out.append(F.linear(x, w, b))
        return out

    def forward(self, a, bias, split: int):
        cfg = self.cfg
        b, s, h = a.shape
        nh, d = cfg.encoder_attention_heads, cfg.head_dim
        qkv = merge_rows(*self._qkv(*split_rows(a, split)), b)
        q, k, v = (qkv[..., i * h:(i + 1) * h].view(b, s, nh, d)
                   for i in range(3))
        ctx = multi_head_attention(q, k, v, bias, impl=cfg.attention_impl)
        c = self.inner_attn_ln.tail(ctx.reshape(b, s, h), None, split)
        return merge_rows(*self.out_proj(*split_rows(c, split)), b)


class EncoderLayer(nn.Module):
    """torchscale's pre-LN ``EncoderLayer`` with ``multiway`` and
    ``subln``, at inference."""

    def __init__(self, cfg: Beit3Config):
        super().__init__()
        h, eps = cfg.encoder_embed_dim, cfg.layernorm_eps
        self.self_attn = MultiheadAttention(cfg)
        self.self_attn_layer_norm = MultiwayLayerNorm(h, eps)
        self.ffn = Multiway(FeedForward(cfg), FeedForward(cfg))
        self.final_layer_norm = MultiwayLayerNorm(h, eps)

    def forward(self, x, a, bias, split: int):
        """(y, h) from the residual stream ``x`` and ``a`` =
        ``self_attn_layer_norm(x)``: h = x + the attention branch, y the FFN
        branch's output, which the next tail adds to h (the next layer's
        ``self_attn_layer_norm`` or the encoder's output norm takes both)."""
        b = x.shape[0]
        y = self.self_attn(a, bias, split)
        h, f = self.final_layer_norm.tail(y, x, split)
        fv, ft = split_rows(f, split)
        _count_rows(fv, ft)
        _count_rows(fv, ft)  # fc1 and fc2
        trace.count("tail.plain")  # LNffn_m
        return merge_rows(self.ffn.A(fv), self.ffn.B(ft), b), h


class VisionEmbedding(nn.Module):
    """torchscale's ``VisionEmbedding``: the patch convolution and a
    learned CLS."""

    def __init__(self, cfg: Beit3Config):
        super().__init__()
        h, p = cfg.encoder_embed_dim, cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_chans, h, kernel_size=p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, h))


class Encoder(nn.Module):
    def __init__(self, cfg: Beit3Config):
        super().__init__()
        h, dt = cfg.encoder_embed_dim, cfg.compute_dtype
        self.embed_positions = Multiway(
            Embed(cfg.split + POS_OFFSET, h, dt),
            Embed(cfg.max_source_positions, h, dt))
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.encoder_layers))
        if cfg.normalize_output:
            self.layer_norm = MultiwayLayerNorm(h, cfg.layernorm_eps)


class Beit3Model(nn.Module):
    """torchscale's ``BEiT3``: embeddings and the multiway encoder."""

    def __init__(self, cfg: Beit3Config):
        super().__init__()
        self.cfg = cfg
        self.text_embed = Embed(cfg.vocab_size, cfg.encoder_embed_dim,
                                cfg.compute_dtype)
        self.vision_embed = VisionEmbedding(cfg)
        self.encoder = Encoder(cfg)

    def embed(self, pixel_values, img_index, input_ids):
        """[pairs, split + T, H]: each image's patches embedded once, then
        gathered to its pairs beside the text rows."""
        cfg, dt = self.cfg, self.cfg.compute_dtype
        ve, pos = self.vision_embed, self.encoder.embed_positions
        px = (pixel_values.float() * (1.0 / 127.5) - 1.0).to(dt)
        patches = F.conv2d(px, ve.proj.weight.to(dt), ve.proj.bias.to(dt),
                           stride=cfg.patch_size).flatten(2).transpose(1, 2)
        cls = ve.cls_token.to(dt).expand(patches.shape[0], -1, -1)
        vis = (torch.cat((cls, patches), 1)
               + pos.A.weight[POS_OFFSET:POS_OFFSET + cfg.split].to(dt))
        t = input_ids.shape[1]
        txt = (self.text_embed(input_ids)
               + pos.B.weight[POS_OFFSET:POS_OFFSET + t].to(dt))
        return merge_rows(vis[img_index], txt, input_ids.shape[0])

    def forward(self, pixel_values, img_index, input_ids, text_mask):
        split = self.cfg.split
        with trace.span("beit3.embed"):
            x = self.embed(pixel_values, img_index, input_ids)
        with trace.span("beit3.encoder"):
            b = x.shape[0]
            bias = torch.cat((x.new_zeros((b, split), dtype=torch.float32),
                              (1.0 - text_mask.float()) * MASK_VALUE), 1)
            layers = self.encoder.layers
            out_ln = getattr(self.encoder, "layer_norm", None)
            a = layers[0].self_attn_layer_norm.tail(x, None, split)
            for i, layer in enumerate(layers):
                y, h = layer(x, a, bias, split)
                if i + 1 < len(layers):
                    x, a = layers[i + 1].self_attn_layer_norm.tail(y, h,
                                                                   split)
                elif out_ln is not None:
                    _, x = out_ln.tail(y, h, split, keep_sum=False)
                else:
                    x = h + y
        return x


class Pooler(nn.Module):
    """Row 0 -> LN -> Linear -> tanh (``modeling_finetune.py`` ``Pooler``)."""

    def __init__(self, h: int, eps: float):
        super().__init__()
        self.norm = LayerNorm(h, eps)
        self.dense = Linear(h, h)

    def forward(self, x):
        x0 = x[:, 0].contiguous()
        y = inference_tail(x0, None, self.norm.weight, self.norm.bias,
                           self.norm.eps) if not torch.is_grad_enabled() \
            else None
        trace.count("tail.plain" if y is None else "tail.fused")
        if y is None:
            y = plain_layer_norm(x0, self.norm)
        return torch.tanh(self.dense(y))


class Beit3ForVisualQuestionAnswering(nn.Module):
    """``BEiT3ForVisualQuestionAnswering``: the encoder, the pooler and
    Linear(H, 2H) -> LN(2H) -> GELU -> Linear(2H, num_answer) as
    ``head.0``, ``head.1``, ``head.3``."""

    def __init__(self, cfg: Beit3Config, num_answer: int = 3129):
        super().__init__()
        h, eps = cfg.encoder_embed_dim, cfg.layernorm_eps
        self.config = cfg
        self.beit3 = Beit3Model(cfg)
        self.pooler = Pooler(h, eps)
        self.head = nn.Sequential(Linear(h, 2 * h), LayerNorm(2 * h, eps),
                                  nn.GELU(), Linear(2 * h, num_answer))

    def predict(self, batch, *, deterministic: bool = True,
                generator=None) -> torch.Tensor:
        """fp32 logits [pairs, num_answer] of a batch (module docstring)."""
        if not deterministic or torch.is_grad_enabled():
            raise NotImplementedError("BEiT-3 runs inference only in this "
                                      "port (no dropout, no gradient)")
        x = self.beit3(batch["pixel_values"], batch["img_index"],
                       batch["input_ids"], batch["text_mask"])
        with trace.span("beit3.head"):
            p = self.pooler(x)
            head = self.head
            trace.count("tail.plain")
            y = plain_layer_norm(head[0](p), head[1])
            return head[3](F.gelu(y)).float()

    def forward(self, batch, compute_loss: bool = True, **kw):
        if compute_loss:
            raise NotImplementedError("training BEiT-3 is not supported by "
                                      "this port (inference only)")
        return self.predict(batch, **kw)
